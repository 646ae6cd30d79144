"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

It mirrors the JAX package's layout (``ops``, ``models``, ``llm``,
``_private``) so each module's counterpart is easy to find, imports no JAX
and nothing of ``ray_tpu``, and runs on CUDA unless a caller asks for the
CPU.  Each Pallas TPU kernel on a ported path becomes a hand-written
kernel under ``ops/csrc``.  ROADMAP.md lists what is ported and what is
still to come.
"""
