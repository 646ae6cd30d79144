"""Stable prefix chain hashing (a copy of ``ray_tpu/_private/prefix_hash.py``).

The paged engine's prefix cache chains full prompt blocks:
``h_i = H(h_{i-1}, tokens[i*bs:(i+1)*bs])`` (llm/paged.py BlockManager —
the vLLM block-hash scheme).  Cache-aware routing compares these chains
across processes and machines, and across the JAX and PyTorch engines, so
the hash must be stable: Python's builtin ``hash`` randomizes str/bytes per
process, and even int-tuple hashing is an implementation detail.  blake2b
(keyed into 64 bits) is stable, collision-resistant far beyond the 64-bit
budget, and C-speed.

The port keeps its own copy instead of importing the JAX package's module:
``ray_tpu_torch`` imports nothing of ``ray_tpu``.  The seed and encoding
must stay bit-equal to the original (tests/test_torch_paged_engine.py).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence

_SEED = b"ray_tpu-prefix-v1"


def chain_hash(prev: Optional[int], tokens: Sequence[int]) -> int:
    """One chain link: hash of (previous link, this block's token ids).

    Token ids are encoded as 4-byte little-endian signed (they are vocab
    indices, always < 2**31); the previous hash as 8-byte.  One C-level
    struct.pack, not a per-token to_bytes loop — this sits on the
    admission and routing hot paths.  Returns an unsigned 64-bit int
    (JSON-safe)."""
    h = hashlib.blake2b(_SEED, digest_size=8)
    h.update((prev or 0).to_bytes(8, "little"))
    h.update(struct.pack(f"<{len(tokens)}i", *tokens))
    return int.from_bytes(h.digest(), "little")


def content_hash(data, *, extra: bytes = b"") -> int:
    """Keyed blake2b over a raw byte buffer (bytes / memoryview / anything
    exposing the buffer protocol, e.g. a C-contiguous numpy array).

    Shared by the checkpoint subsystem's per-leaf delta hashing
    (train/_internal/snapshot.py): two leaves with identical bytes AND
    identical ``extra`` (shape/dtype/shard-index framing, so a reshaped or
    re-typed view never aliases) hash equal across processes and machines —
    the same stability contract as :func:`chain_hash`.  Returns an unsigned
    64-bit int (JSON-safe)."""
    h = hashlib.blake2b(_SEED, digest_size=8)
    h.update(extra)
    h.update(data)
    return int.from_bytes(h.digest(), "little")


def prefix_chain_hashes(prompt: Sequence[int], block_size: int,
                        limit: Optional[int] = None) -> List[int]:
    """Chain hashes of the full blocks a prefix-cache match may cover:
    ``(len(prompt) - 1) // block_size`` links (the last prompt token is
    always recomputed so sampling has a logit — match_prefix convention).
    ``limit`` caps the number of links (routing only needs the head)."""
    if block_size <= 0 or len(prompt) <= 1:
        return []
    n = (len(prompt) - 1) // block_size
    if limit is not None:
        n = min(n, limit)
    out: List[int] = []
    h: Optional[int] = None
    for i in range(n):
        h = chain_hash(h, prompt[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


def longest_chain_match(chain: Sequence[int], held) -> int:
    """Length of the leading run of ``chain`` present in ``held`` (a set of
    chain hashes).  The chain property makes a leading-run test sufficient:
    link i can only be held meaningfully if links 0..i-1 are too."""
    n = 0
    for h in chain:
        if h not in held:
            break
        n += 1
    return n
