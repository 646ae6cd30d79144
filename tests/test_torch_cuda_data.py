"""The data layer's device double buffer on the card.

``DevicePrefetcher`` at depth 2 over host batches that are read-only numpy
views (as the store hands blocks back):

  - a consumer that spins ``torch.cuda._sleep`` on its own stream before it
    reads each batch, while the stager's side stream starts behind a long
    ``_sleep`` of its own (the copies land late): every batch must equal
    its host rows.  The consumer drops each batch at once, so the caching
    allocator would hand its memory to a later copy if ``record_stream``
    were missing;
  - the control, a stager that skips the ``wait_event`` hand-off, must
    fail the same check (the consumer reads before the copy lands);
  - the pinned ring stays at depth + 1 buffers a column over 100 batches,
    with no pinned allocation after the first batch;
  - a short last batch in each partial mode;
  - no ``torch.cuda.synchronize`` on the path.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch, numpy and ray_tpu_torch, so it runs
where JAX is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_data.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.data._internal.ingest import DevicePrefetcher, DeviceStager

pytestmark = pytest.mark.cuda

DEPTH = 2
SIDE_DELAY = 200_000_000  # cycles (~0.1 s) on the side stream before any copy
STEP = 2_000_000  # cycles (~1 ms) the consumer spins before each read


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the double buffer's streams and "
                    "pinned ring are the card's")


def _host_batches(n, rows=16, width=4096, seed=0):
    """n batches of read-only int32 [rows, width] and int64 [rows] columns,
    every value distinct from the last batch's."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tok = rng.integers(1, 2**31 - 1, (rows, width), dtype=np.int32)
        ids = np.arange(i * rows, (i + 1) * rows, dtype=np.int64)
        for a in (tok, ids):
            a.setflags(write=False)
        out.append({"tok": tok, "id": ids})
    return out


class NoWait(DeviceStager):
    """The control: hands the batch over without the consumer's stream
    waiting on the copy's event."""

    def hand_over(self, staged):
        stream = torch.cuda.current_stream(self.device)
        for t in staged.tensors.values():
            t.record_stream(stream)
        return staged.tensors


def _run(stager_cls, batches):
    """What a slow consumer reads: (its copies of each batch, the host's)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(SIDE_DELAY)
    stager = stager_cls(dev, depth=DEPTH, stream=side)
    read = []
    for batch in DevicePrefetcher(iter(batches), dev, depth=DEPTH,
                                  stager=stager):
        torch.cuda._sleep(STEP)
        read.append({k: v.clone() for k, v in batch.items()})
        del batch  # dropped at once: its memory is free to the allocator
    torch.cuda.synchronize()  # the test's own check, after the path
    return read


def _mismatches(read, batches):
    return sum(not (np.array_equal(r["tok"].cpu().numpy(), b["tok"])
                    and np.array_equal(r["id"].cpu().numpy(), b["id"]))
               for r, b in zip(read, batches)) + abs(len(read) - len(batches))


def test_double_buffer_against_a_slow_consumer():
    batches = _host_batches(40)
    read = _run(DeviceStager, batches)
    assert read[0]["tok"].is_cuda and read[0]["tok"].dtype == torch.int32
    assert _mismatches(read, batches) == 0


def test_the_control_without_wait_event_fails_the_check():
    batches = _host_batches(40)
    assert _mismatches(_run(NoWait, batches), batches) > 0


def test_the_pinned_ring_stays_at_depth_plus_one():
    dev = torch.device("cuda", torch.cuda.current_device())
    batches = _host_batches(100, rows=8, width=256, seed=1)
    stager = DeviceStager(dev, depth=DEPTH)
    pinned = []
    empty = torch.empty

    def counting_empty(*args, **kw):
        if kw.get("pin_memory"):
            pinned.append(args)
        return empty(*args, **kw)

    torch.empty = counting_empty
    try:
        it = iter(DevicePrefetcher(iter(batches), dev, depth=DEPTH,
                                   stager=stager))
        first = next(it)
        after_first = len(pinned)
        rest = list(it)
    finally:
        torch.empty = empty
    assert {k: len(v) for k, v in stager._ring.items()} == {
        "tok": DEPTH + 1, "id": DEPTH + 1}
    assert after_first == 2 * (DEPTH + 1)
    assert len(pinned) == after_first  # nothing pinned after the first batch
    torch.cuda.synchronize()
    assert _mismatches([first] + rest, batches) == 0


@pytest.mark.parametrize("mode,sizes", [("error", [16, 16, 5]),
                                        ("drop", [16, 16]),
                                        ("pad", [16, 16, 16])])
def test_a_short_last_batch_in_each_partial_mode(mode, sizes):
    dev = torch.device("cuda", torch.cuda.current_device())
    batches = _host_batches(3, seed=2)
    last = {k: v[:5] for k, v in batches[-1].items()}
    batches[-1] = last
    got = list(DevicePrefetcher(iter(batches), dev, depth=DEPTH,
                                batch_size=16, partial_batch=mode))
    torch.cuda.synchronize()
    assert [len(b["id"]) for b in got] == sizes
    if mode == "drop":
        return
    tail = got[-1]
    assert np.array_equal(tail["tok"][:5].cpu().numpy(), last["tok"])
    if mode == "pad":
        assert tail["mask"].tolist() == [1.0] * 5 + [0.0] * 11
        assert not tail["tok"][5:].any()
    else:
        assert "mask" not in tail


def test_no_synchronize_on_the_path():
    dev = torch.device("cuda", torch.cuda.current_device())
    batches = _host_batches(20, seed=3)
    calls = []
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: calls.append(a)
    try:
        read = []
        for batch in DevicePrefetcher(iter(batches), dev, depth=DEPTH,
                                      dtypes={"tok": torch.float32}):
            torch.cuda._sleep(STEP)
            read.append(batch["tok"].sum())
    finally:
        torch.cuda.synchronize = sync
    torch.cuda.synchronize()
    assert calls == []
    want = [float(b["tok"].astype(np.float32).sum(dtype=np.float32))
            for b in batches]
    assert len(read) == len(want)
    for r, w in zip(read, want):
        assert float(r) == pytest.approx(w, rel=1e-4)
