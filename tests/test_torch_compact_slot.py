"""The compaction kernel's wrapper (``ops/compact_slot.py``) on the CPU: its
scratch cache (one allocation per device, G and stream over many calls,
replaced before the status words' call tag overflows, dropped after a
refused launch), the arena layout (one allocation a call that holds the
count and one block a dtype, computed once per dtypes and G), the plane
table's split of 4- and 8-byte planes, the launch's pointers through a
stub library that does the kernel's work on host memory (also from several
threads at once, whose calls must reach it in call-number order), and
``segment_agg.read_slot_compact`` against the JAX package's at several
active shares on float64 rings (under ``jax.enable_x64``), bit for bit;
tests/test_torch_window_options.py holds it against the JAX package on
float32 rings.  The kernel itself runs only on the card: ``chip_smoke.py``
phase 25 holds it against its plain version."""

import ctypes
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu_torch.ops import compact_slot as cs
from denormalized_tpu_torch.ops import segment_agg as sa

CPU = torch.device("cpu")
MIXED = (torch.int32, torch.float64, torch.float32, torch.int64,
         torch.float32, torch.float64)


@pytest.fixture(autouse=True)
def _fresh_cache():
    cs._SCRATCH.clear()
    yield
    cs._SCRATCH.clear()


def _host(ptr: int, n: int, ctype) -> np.ndarray:
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class KernelStub:
    """The library's C interface done on host memory, as the kernel does
    it: the active cells of the count plane at ranks 0..k-1 of the gid
    buffer and of every plane (the table's first n4 pairs 4-byte, the rest
    8-byte), k in the count.  It keeps the kernel's ticket rule: a call
    on a scratch finds its ticket counter at (call - 1) x (tiles +
    blocks) and leaves it at call x (tiles + blocks), which holds only if
    calls arrive in call-number order."""

    def __init__(self):
        self.calls = []

    def compact_slot_launch(self, counts, G, n4, n8, table, aligned, gids,
                            n, status, tickets, call, blocks, stream):
        self.calls.append((tickets, call, aligned, blocks, stream))
        per_call = cs.tiles_of(G) + blocks
        counter = _host(tickets, 1, ctypes.c_int64)
        assert status == tickets + 8
        assert counter[0] == (call - 1) * per_call, (
            f"call {call} queued out of order")
        counter[0] = call * per_call
        active = np.flatnonzero(_host(counts, G, ctypes.c_int32) > 0)
        k = len(active)
        _host(gids, G, ctypes.c_int32)[:k] = active
        _host(n, 1, ctypes.c_int32)[0] = k
        pairs = list(table)
        for j in range(n4 + n8):
            ct = ctypes.c_int32 if j < n4 else ctypes.c_int64
            src = _host(pairs[2 * j], G, ct)
            _host(pairs[2 * j + 1], G, ct)[:k] = src[active]
        return 0

    def compact_slot_error_string(self, code):
        return b"refused"


def _inputs(G, dtypes, share, seed):
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random(G) < share, rng.integers(1, 9, G), 0)
    planes = [torch.from_numpy(rng.normal(0, 100, G).astype(
        torch.empty(0, dtype=dt).numpy().dtype)) for dt in dtypes]
    return torch.from_numpy(counts.astype(np.int32)), planes


def _assert_equal_reference(n, groups, counts, planes):
    gids, outs = cs.split_outputs(groups, len(planes))
    rn, rgids, routs = cs.compact_slot_reference(counts, planes)
    k = int(rn.item())
    assert int(n.item()) == k
    assert torch.equal(gids[:k], rgids)
    for o, r in zip(outs, routs):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o[:k].numpy().view(np.uint8),
                                      r.numpy().view(np.uint8))


@pytest.mark.parametrize("G,tiles", [(1, 1), (1024, 1), (1025, 2),
                                     (131_072, 128), (200_000, 196)])
def test_tiles_of(G, tiles):
    assert cs.tiles_of(G) == tiles


def test_scratch_is_cached_per_device_g_and_stream():
    """Many calls on one (device, G, stream) share one zeroed scratch (the
    ticket counter and a status word a tile), numbered 1, 2, ...; another
    G or stream has its own."""
    first, call = cs._scratch(CPU, 131_072, 0)
    assert call == 1
    assert first.words.shape == (129,) and first.words.dtype == torch.int64
    assert int(first.words.abs().sum()) == 0
    calls = [cs._scratch(CPU, 131_072, 0) for _ in range(50)]
    assert all(s is first for s, _ in calls)
    assert [c for _, c in calls] == list(range(2, 52))
    other_g, c = cs._scratch(CPU, 4096, 0)
    other_stream, d = cs._scratch(CPU, 131_072, 7)
    assert c == d == 1
    assert len({id(first), id(other_g), id(other_stream)}) == 3
    assert len(cs._SCRATCH) == 3


def test_scratch_replaced_before_its_tag_overflows():
    s, _ = cs._scratch(CPU, 2048, 0)
    s.calls = cs._MAX_CALLS
    fresh, call = cs._scratch(CPU, 2048, 0)
    assert fresh is not s and call == 1


def test_layout_is_computed_once_per_dtypes_and_g():
    """The arena's layout is a function of (the planes' dtypes, G): many
    calls share one, another dtype list or G has its own."""
    a = cs.layout(MIXED, 131_072)
    assert all(cs.layout(MIXED, 131_072) is a for _ in range(50))
    assert cs.layout(MIXED[:3], 131_072) is not a
    assert cs.layout(MIXED, 4096) is not a


@pytest.mark.parametrize("G", [1, 5, 4096, 131_073])
def test_one_arena_holds_scratch_count_and_outputs(G):
    """A call allocates one byte arena: the count first, then a (rows, G)
    block a dtype, the gids row 0 of the int32 one, every block 16-B
    aligned and none overlapping."""
    planes = [torch.zeros(G, dtype=dt) for dt in MIXED]
    arena, lay = cs.alloc_outputs(G, planes, CPU)
    assert arena.dtype == torch.uint8 and arena.numel() == lay.nbytes
    n, groups = lay.views(arena)
    base = arena.data_ptr()
    assert n.shape == (1,) and n.dtype == torch.int32
    assert n.data_ptr() == base
    assert [(buf.dtype, buf.shape, idx) for buf, idx in groups] == [
        (torch.int32, (2, G), [-1, 0]),
        (torch.float64, (2, G), [1, 5]),
        (torch.float32, (2, G), [2, 4]),
        (torch.int64, (1, G), [3])]
    spans = [(base, base + 4)]
    for buf, _ in groups:
        assert buf.is_contiguous()
        assert buf.untyped_storage().data_ptr() == base
        assert (buf.data_ptr() - base) % cs.ALIGN == 0
        spans.append((buf.data_ptr(),
                      buf.data_ptr() + buf.numel() * buf.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= base + lay.nbytes
    gids, outs = cs.split_outputs(groups, len(planes))
    assert gids.data_ptr() == base + lay.gids_off
    assert [(o.shape, o.dtype) for o in outs] == [(p.shape, p.dtype)
                                                  for p in planes]


def test_plane_table_puts_4_byte_planes_first():
    """The kernel walks 4-byte planes, then 8-byte ones: the table keeps
    each group in the caller's order, each src beside its output row."""
    G = 64
    planes = [torch.zeros(G, dtype=dt) for dt in MIXED]
    arena, lay = cs.alloc_outputs(G, planes, CPU)
    assert lay.order == [0, 2, 4, 1, 3, 5] and (lay.n4, lay.n8) == (3, 3)
    _, outs = cs.split_outputs(lay.views(arena)[1], len(planes))
    table, aligned = cs.plane_table(planes, lay, arena.data_ptr())
    assert list(table) == [v for i in lay.order
                           for v in (planes[i].data_ptr(), outs[i].data_ptr())]
    assert aligned == all(p.data_ptr() % 16 == 0 for p in planes)
    offset = torch.zeros(G + 1)[1:]  # a plane 4 B off a 16-B boundary
    _, aligned = cs.plane_table([offset], cs.layout((torch.float32,), G), 0)
    assert not aligned
    empty, lay = cs.alloc_outputs(G, [], CPU)
    table, aligned = cs.plane_table([], lay, empty.data_ptr())
    assert (lay.n4, lay.n8) == (0, 0) and list(table) == [0, 0] and aligned


@pytest.mark.parametrize("G", [1, 5, 1024, 4099])
@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_launch_pointers_through_a_stub_kernel(monkeypatch, G, share):
    """The launch hands the library the count plane, the table, the gid
    row and the count of one arena, and the cached scratch: a stub doing
    the kernel's work through those pointers gives the plain version's
    outputs bit for bit, in every dtype."""
    stub = KernelStub()
    monkeypatch.setattr(cs, "_lib", lambda: stub)
    counts, planes = _inputs(G, MIXED, share, G)
    before = cs.compact_slot_launches
    n, groups = cs._launch(counts, planes, 7, 1)
    n2, groups2 = cs._launch(counts, planes, 7, 1)
    assert cs.compact_slot_launches == before + 2
    scratch = cs._SCRATCH[(CPU, G, 7)].words.data_ptr()
    assert [c[:2] for c in stub.calls] == [(scratch, 1), (scratch, 2)]
    assert all(c[3:] == (1, 7) for c in stub.calls)
    _assert_equal_reference(n, groups, counts, planes)
    _assert_equal_reference(n2, groups2, counts, planes)


def test_concurrent_calls_reach_the_library_in_call_order(monkeypatch):
    """Window operators emit from several threads on one stream (config
    4's two windows): every call on the shared scratch must reach the
    library in call-number order, or the kernel's first ticket is wrong.
    The interpreter switches threads as often as it can meanwhile."""
    stub = KernelStub()
    monkeypatch.setattr(cs, "_lib", lambda: stub)
    G, errors = 3000, []

    def worker(t):
        try:
            for r in range(6):
                counts, planes = _inputs(G, MIXED[:3], 0.5, 100 * t + r)
                n, groups = cs._launch(counts, planes, 0, 2)
                _assert_equal_reference(n, groups, counts, planes)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[0]
    assert [c[1] for c in stub.calls] == list(range(1, 49))


def test_refused_launch_drops_the_scratch(monkeypatch):
    """A refused launch takes no tickets, so its scratch's call numbers no
    longer match its counter: the wrapper forgets it, raises, and does
    not count a launch."""
    stub = KernelStub()
    monkeypatch.setattr(cs, "_lib", lambda: stub)
    counts, planes = _inputs(64, MIXED[:2], 0.5, 0)
    cs._launch(counts, planes, 0, 1)
    assert (CPU, 64, 0) in cs._SCRATCH
    stub.compact_slot_launch = lambda *a: 1
    before = cs.compact_slot_launches
    with pytest.raises(RuntimeError, match="refused"):
        cs._launch(counts, planes, 0, 1)
    assert cs.compact_slot_launches == before
    assert (CPU, 64, 0) not in cs._SCRATCH


def _ring(G, share, seed):
    """A seeded float64 (4, G) ring of count/sum/min/max planes with slot 2
    holding ``share`` of its cells active, NaNs and -0.0 among the
    values."""
    rng = np.random.default_rng(seed)
    dt = np.float64
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(
            [("count", 0), ("sum", 0), ("min", 0), ("max", 0)])),
        num_value_cols=1, window_slots=4, group_capacity=G, length_ms=1000,
        slide_ms=1000, accum_dtype=torch.float64)
    active = np.zeros((4, G), bool)
    for w in range(4):
        active[w, rng.choice(G, int(round(share * G)), replace=False)] = True
    rc = np.where(active, rng.integers(1, 9, (4, G)), 0).astype(np.int32)
    host = {"count_star": rc, "count_0": rc.copy(),
            "sum_0": np.where(active, rng.normal(50, 10, (4, G)), 0).astype(dt),
            "min_0": np.where(active, rng.normal(50, 10, (4, G)),
                              np.inf).astype(dt),
            "max_0": np.where(active, rng.normal(50, 10, (4, G)),
                              -np.inf).astype(dt)}
    host["sum_0"][2, rng.integers(0, G, 3)] = np.nan
    host["min_0"][2, rng.integers(0, G, 2)] = -0.0
    return spec, host


@pytest.mark.parametrize("share", [0.0, 0.001, 0.1, 0.76, 1.0])
def test_read_slot_compact_f64_matches_the_jax_package(share):
    """read_slot_compact (the kernel's plain version on the CPU) against
    the JAX package's on the same seeded float64 ring, the JAX package's
    x64 on for the call: the same gids, ascending, and every component row
    bit for bit."""
    G = 4096
    spec, host = _ring(G, share, int(share * 1000) + 3)
    state = sa.import_state(spec, host, "cpu")
    gids, rows = sa.read_slot_compact(spec, state, 2)
    jspec = jsa.WindowKernelSpec(
        components=tuple(jsa.components_for(
            [("count", 0), ("sum", 0), ("min", 0), ("max", 0)])),
        num_value_cols=1, window_slots=4, group_capacity=G, length_ms=1000,
        slide_ms=1000, accum_dtype=jnp.float64)
    with jax.enable_x64(True):
        jstate = jsa.import_state(jspec, host)
        jgids, jrows = jsa.read_slot_compact(jspec, jstate, 2)
        jgids = np.asarray(jgids)
        jrows = {k: np.asarray(v) for k, v in jrows.items()}
    want = np.nonzero(host["count_star"][2] > 0)[0]
    np.testing.assert_array_equal(gids, want)
    np.testing.assert_array_equal(gids, jgids)
    assert set(rows) == set(jrows)
    for label, arr in rows.items():
        assert arr.dtype == jrows[label].dtype, label
        np.testing.assert_array_equal(arr.view(np.uint8),
                                      jrows[label].view(np.uint8),
                                      err_msg=label)
