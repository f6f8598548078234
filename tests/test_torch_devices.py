"""The launch guard and the table uploads on a host with several cards,
checked on the CPU with the ctypes launchers replaced by recorders and a
fake torch.cuda.device that records the device it enters:

- kernels/pz.py:upload_tables copies the basis tables into a library's
  constant memory once per (device, library), again on a device whose
  tables change (after waiting for that device only), each copy inside
  that device's guard;
- kernels/build.py:on_device enters its tensor's device and yields that
  device's current stream; every launcher calls its C function inside it
  (checked on the sources, and by running K3's wrapper)."""

import ast
import ctypes
import types
from pathlib import Path

import pytest
import torch

from armour_tpu_torch.kernels import build, collision as kcol, pz as kpz
from armour_tpu_torch.pz.basis import error_layout, make_basis

KERNEL_DIR = Path(build.__file__).resolve().parent
LAUNCHING_MODULES = ("collision.py", "grasp.py", "jrs.py", "pz.py", "reach.py", "sim.py",
                     "solver.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as every port test file pins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Cards:
    """A fake torch.cuda.device / current_stream / synchronize: the device
    entered is tracked, and every event recorded."""

    def __init__(self):
        self.current = torch.device("cuda", 0)
        self.events = []

    def device(self, dev):
        cards = self

        class _Guard:
            def __enter__(self):
                self.prev = cards.current
                cards.current = torch.device(dev)
                cards.events.append(("enter", cards.current))

            def __exit__(self, *exc):
                cards.current = self.prev
                cards.events.append(("exit", torch.device(dev)))
                return False

        return _Guard()

    def current_stream(self, dev):
        dev = torch.device(dev)
        return types.SimpleNamespace(cuda_stream=1000 + (dev.index or 0))

    def synchronize(self, dev=None):
        self.events.append(("synchronize", torch.device(dev)))


@pytest.fixture
def cards(monkeypatch):
    c = _Cards()
    monkeypatch.setattr(torch.cuda, "device", c.device)
    monkeypatch.setattr(torch.cuda, "current_stream", c.current_stream)
    monkeypatch.setattr(torch.cuda, "synchronize", c.synchronize)
    return c


@pytest.fixture
def uploads(cards, monkeypatch):
    """The upload functions replaced by recorders of (library, device the
    call ran on, the tables' basis size and error slots)."""
    calls = []

    def launcher(name, symbol, argtypes):
        def fn(tables):
            t = tables._obj
            calls.append((name, cards.current, t.B, t.E))
            return 0
        return fn

    monkeypatch.setattr(kpz, "launcher", launcher)
    monkeypatch.setattr(kpz, "_UPLOADED", {})
    return calls


def test_upload_tables_once_per_device_and_library(cards, uploads):
    basis = make_basis(7, 3)
    E = error_layout(7)["size"]
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    kpz.upload_tables("fk_chain", "k9_tables", basis, E, d0)
    kpz.upload_tables("fk_chain", "k9_tables", basis, E, d0)
    assert uploads == [("fk_chain", d0, 120, E)]
    # a planner on the second card, made after one on the first: its own copy
    kpz.upload_tables("fk_chain", "k9_tables", basis, E, d1)
    kpz.upload_tables("rnea_chain", "k10_tables", basis, E, d1)
    kpz.upload_tables("fk_chain", "k9_tables", basis, E, d1)
    assert uploads[1:] == [("fk_chain", d1, 120, E), ("rnea_chain", d1, 120, E)]
    assert set(kpz._UPLOADED) == {(0, "fk_chain"), (1, "fk_chain"), (1, "rnea_chain")}
    assert not any(e[0] == "synchronize" for e in cards.events)
    assert cards.current == d0


def test_upload_tables_again_after_a_change_on_that_device(cards, uploads):
    basis = make_basis(7, 3)
    E = error_layout(7)["size"]
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for d in (d0, d1):
        kpz.upload_tables("pz_cross", "k2_tables", basis, E, d)
    cards.events.clear()
    # other tables (another error width) on card 1: card 1 waits, then copies
    kpz.upload_tables("pz_cross", "k2_tables", basis, E - 2, d1)
    assert uploads[-1] == ("pz_cross", d1, 120, E - 2)
    assert cards.events == [("enter", d1), ("synchronize", d1), ("exit", d1)]
    # card 0 keeps its tables and is neither waited for nor written
    kpz.upload_tables("pz_cross", "k2_tables", basis, E, d0)
    assert len(uploads) == 3
    kpz.upload_tables("pz_cross", "k2_tables", basis, E, d1)
    assert uploads[-1] == ("pz_cross", d1, 120, E)
    assert [e for e in cards.events if e[0] == "synchronize"] == [("synchronize", d1)] * 2


def test_upload_failure_raises_and_is_not_remembered(cards, monkeypatch):
    monkeypatch.setattr(kpz, "launcher", lambda *a: (lambda t: 700))
    monkeypatch.setattr(kpz, "_UPLOADED", {})
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kpz.upload_tables("fk_chain", "k9_tables", make_basis(7, 3), error_layout(7)["size"],
                          torch.device("cuda", 1))
    assert kpz._UPLOADED == {}


@pytest.mark.parametrize("index", [0, 1, 3])
def test_on_device_enters_the_tensors_device(cards, index):
    t = types.SimpleNamespace(device=torch.device("cuda", index))
    with build.on_device(t) as stream:
        assert cards.current == torch.device("cuda", index)
        assert isinstance(stream, ctypes.c_void_p) and stream.value == 1000 + index
    assert cards.current == torch.device("cuda", 0)
    assert cards.events == [("enter", t.device), ("exit", t.device)]


def test_a_wrapper_launches_inside_its_tensors_guard(cards, monkeypatch):
    """K3's wrapper (its checks stubbed for CPU tensors) calls its C launch
    function inside on_device of its tensors, with that device's stream."""
    calls = []

    def launcher(name, symbol, argtypes):
        def fn(args, stream):
            calls.append((name, cards.current, stream.value))
            return 0
        return fn

    monkeypatch.setattr(kcol, "launcher", launcher)
    monkeypatch.setattr(kcol, "_require", lambda *a, **k: None)
    monkeypatch.setattr(kcol, "launched", lambda *a: None)
    cards.current = torch.device("cuda", 2)
    kcol.build_hyperplanes(torch.zeros(1, 2, 7, 3, 3), torch.zeros(1, 2, 7, 3),
                           torch.zeros(1, 4, 3), torch.zeros(1, 4, 3, 3))
    assert calls == [("build_hyperplanes", torch.device("cpu"), 1000)]
    assert cards.current == torch.device("cuda", 2)


def _launch_calls(tree):
    """(function, call node, guarded) for every call of a C function: a call
    of a name bound to launcher(...) in the same function, or of
    launcher(...)(...) directly; guarded when a `with on_device(...)` (or,
    for a table upload, `with torch.cuda.device(...)`) encloses it."""
    out = []

    def guard(item):
        f = item.context_expr.func if isinstance(item.context_expr, ast.Call) else None
        return ((isinstance(f, ast.Name) and f.id == "on_device")
                or (isinstance(f, ast.Attribute) and f.attr == "device"))

    def visit(node, fn_node, bound, guarded):
        if isinstance(node, ast.With):
            guarded = guarded or any(guard(i) for i in node.items)
        if isinstance(node, ast.Call):
            f = node.func
            direct = (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
                      and f.func.id == "launcher")
            if direct or (isinstance(f, ast.Name) and f.id in bound):
                out.append((fn_node.name, node.lineno, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, fn_node, bound, guarded)

    for fn_node in ast.walk(tree):
        if not isinstance(fn_node, ast.FunctionDef):
            continue
        bound = {t.id for n in ast.walk(fn_node) if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Call) and isinstance(n.value.func, ast.Name)
                 and n.value.func.id == "launcher" for t in n.targets
                 if isinstance(t, ast.Name)}
        for stmt in fn_node.body:
            visit(stmt, fn_node, bound, False)
    return out


@pytest.mark.parametrize("module", LAUNCHING_MODULES)
def test_every_launch_runs_inside_the_device_guard(module):
    calls = _launch_calls(ast.parse((KERNEL_DIR / module).read_text()))
    assert calls, f"{module}: no C launch found"
    bad = [(f, line) for f, line, guarded in calls if not guarded]
    assert not bad, f"{module}: C calls outside on_device: {bad}"


def test_no_launcher_keeps_its_own_stream_helper():
    for module in LAUNCHING_MODULES:
        text = (KERNEL_DIR / module).read_text()
        assert "current_stream" not in text, module
        assert "def _stream" not in text, module


def test_timing_events_record_on_the_devices_stream(cards, monkeypatch):
    """utils.timing.device_ms records its events on the timed device's
    current stream, not the current device's."""
    from armour_tpu_torch.utils import timing

    recorded = []

    class _Event:
        def __init__(self, enable_timing):
            pass

        def record(self, stream=None):
            recorded.append(stream.cuda_stream)

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    assert timing.device_ms(lambda: None, "cuda:3", iters=2, warmup=0) == [1.0, 1.0]
    assert recorded == [1003] * 4


def test_bench_keeps_the_jax_contract():
    """utils.timing.bench(fn, *args) -> (best seconds, last output), as the
    JAX package's; on the CPU nothing to wait for."""
    from armour_tpu_torch.utils.timing import bench

    seen = []
    best, out = bench(lambda a, b: seen.append((a, b)) or torch.ones(2) * a, 2, 3, iters=3,
                      warmup=2)
    assert seen == [(2, 3)] * 5 and torch.equal(out, torch.full((2,), 2.0)) and best >= 0.0


def test_bench_waits_for_every_visible_card(cards, monkeypatch):
    """On a host with cards, bench ends each timed call when every visible
    card is idle, whatever device the output is on."""
    from armour_tpu_torch.utils.timing import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    best, out = bench(lambda a: a + 1, 1, iters=2, warmup=1)
    assert out == 2 and best >= 0.0
    assert cards.events == [("synchronize", torch.device("cuda", i)) for i in range(3)] * 3
