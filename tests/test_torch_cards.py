"""The port on several cards, checked on the CPU.

* Every call into a kernel library (the nine kernels' ``csrc/*.cu`` and
  ``graph_cond.cu``) goes through ``_build.call_on``, the one place that
  makes the tensors' card current: read from each module's syntax tree,
  since no card is here.  ``call_on`` itself enters the card only when it
  is not the current one.
* ``ranks.spawn(fn, None)``, ``ranks.cards`` and ``chip_smoke.py``'s
  cards phase place one rank a card (``nccl`` between them) and refuse
  fewer cards than ranks, with the card count patched.
* Four ``gloo`` ranks on the CPU: ``ranks.all_reduce`` and
  ``ranks.reduce_scatter`` give every rank the same bits.
* ``Group.run_batch`` with no ``devices`` takes
  ``placement.default_devices``: every card present for a group on a
  card (as the reference shards over ``jax.devices()``), the group's own
  device on the CPU.
"""

import ast
import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import placement, ranks
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
LIBRARY_MODULES = sorted(
    str(p.relative_to(PORT)) for p in [*(PORT / "kernels").glob("*.py"),
                                       PORT / "core" / "graphloop.py"]
    if "_build.load(" in p.read_text())


def _lib_names(fn: ast.AST) -> set:
    """Names a function binds to ``_lib()`` or to the C functions of a
    cached caller (``buf, scale, fn = _caller()``)."""
    names = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call) or not isinstance(node.value.func,
                                                        ast.Name):
            continue
        called = node.value.func.id
        for target in node.targets:
            if called == "_lib" and isinstance(target, ast.Name):
                names.add(target.id)
            elif called.startswith("_caller") and isinstance(
                    target, ast.Tuple):
                names.add(target.elts[-1].id)
    return names


def _calls_into_library(tree: ast.Module) -> list:
    """Every call of a C function not made by ``_build.call_on``: a call
    of an attribute of ``_lib()`` or of a name bound to it, or of a
    caller's C function."""
    found = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        bound = _lib_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and (
                    (isinstance(f.value, ast.Call)
                     and getattr(f.value.func, "id", None) == "_lib")
                    or (isinstance(f.value, ast.Name)
                        and f.value.id in bound)):
                found.append((fn.name, node.lineno))
            elif isinstance(f, ast.Name) and f.id in bound:
                found.append((fn.name, node.lineno))
    return found


@pytest.mark.parametrize("module", LIBRARY_MODULES)
def test_every_library_call_goes_through_the_device_guard(module):
    text = (PORT / module).read_text()
    tree = ast.parse(text)
    assert _calls_into_library(tree) == [], module
    guarded = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr == "call_on"
               and getattr(n.func.value, "id", None) == "_build"]
    assert guarded, f"{module} never calls _build.call_on"
    assert "torch.cuda.device(" not in text, \
        f"{module} enters a card itself; _build.call_on is the one guard"


def test_the_syntax_check_sees_an_unguarded_call():
    tree = ast.parse("def launch(x):\n"
                     "    lib = _lib()\n"
                     "    lib.quantize_launch(x)\n"
                     "    _lib().dequantize_launch(x)\n"
                     "    buf, fn = _caller()\n"
                     "    fn(buf)\n"
                     "    _build.call_on(0, fn, buf)\n")
    assert _calls_into_library(tree) == [("launch", 3), ("launch", 4),
                                         ("launch", 6)]


@pytest.mark.parametrize("current,enters", [(1, []), (0, [1])])
def test_call_on_enters_the_card_only_when_it_is_not_current(
        monkeypatch, current, enters):
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    assert _build.call_on(1, lambda a, b: a + b, 2, 3) == 5
    assert entered == enters


@pytest.fixture
def cards(monkeypatch):
    """Pretend ``n`` cards are present: ``cards(n)``."""
    def have(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return have


def test_spawn_places_one_rank_a_card_over_nccl(cards):
    cards(4)
    want = [torch.device("cuda", i) for i in range(4)]
    assert ranks._devices(None) == want
    assert ranks.cards(4) == want and ranks.cards(2) == want[:2]
    assert ranks.backend_for(want) == "nccl"
    assert ranks._devices(["cuda:0", "cuda:3"]) == [want[0], want[3]]
    assert ranks.backend_for(["cuda:0", "cuda:0"]) == "gloo"


def test_spawn_refuses_fewer_cards_than_ranks(cards):
    cards(2)
    with pytest.raises(RuntimeError, match="4 cards; 2 present"):
        ranks.cards(4)
    with pytest.raises(RuntimeError, match=r"\['cuda:3'\]: 2 cards"):
        ranks.spawn(print, ["cuda:0", "cuda:3"])
    cards(0)
    with pytest.raises(RuntimeError, match="no.*available|none is"):
        ranks.spawn(print, None)


def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", module)
    spec.loader.exec_module(module)
    return module


def test_the_cards_phase_takes_one_card_a_rank_and_refuses_three(
        cards, capsys, monkeypatch):
    smoke = _chip_smoke(monkeypatch)
    cards(4)
    two, four = smoke.cards_devices()
    assert [str(d) for d in two] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in four] == [f"cuda:{i}" for i in range(4)]
    assert ranks.backend_for(two) == ranks.backend_for(four) == "nccl"
    cards(3)
    with pytest.raises(SystemExit) as exit_:
        smoke.cards_devices()
    assert exit_.value.code != 0
    assert "needs 4 cards; 3 present" in capsys.readouterr().err


def test_default_devices_are_every_card_for_a_group_on_a_card(cards):
    assert placement.default_devices("cpu") is None
    cards(4)
    want = [torch.device("cuda", i) for i in range(4)]
    assert placement.default_devices("cuda:0") == want
    assert placement.default_devices(torch.device("cuda", 2)) == want
    cards(1)
    assert placement.default_devices("cuda:0") == want[:1]
    assert placement.shard_count(4, want[:1]) == 1


def test_run_batch_without_devices_takes_the_default_list(monkeypatch):
    """The grid's default placement is ``default_devices`` of the group's
    device: given two devices it shards, and every point is the
    unsharded run's."""
    cfg = api.single_group(4, n_senders=2, msg_size=512, window=8,
                           n_messages=8)
    group = api.Group(cfg, device="cpu")
    whole = group.run_batch(backend="kernel", windows=[4, 8])
    asked, chunks = [], []
    real = placement.shard_over_batch
    monkeypatch.setattr(placement, "default_devices",
                        lambda dev: asked.append(dev) or ["cpu", "cpu"])
    monkeypatch.setattr(placement, "shard_over_batch",
                        lambda *a, **k: chunks.append(a[1]) or real(*a, **k))
    sharded = group.run_batch(backend="kernel", windows=[4, 8])
    assert asked == [torch.device("cpu")] and chunks == [["cpu", "cpu"]]
    for a, b in zip(sharded, whole):
        assert a.summary() == b.summary()
        assert a.extras["delivery_logs"].keys() == \
            b.extras["delivery_logs"].keys()


# ---------------------------------------------------------------------------
# four gloo ranks: every rank the same bits
# ---------------------------------------------------------------------------

def _rank_sums(rank, device):
    gen = np.random.default_rng(40 + rank)
    # magnitudes 1e-8 .. 1e8: a sum whose bits depend on its order
    x = torch.from_numpy((gen.standard_normal(4096) * 10.0 ** gen.integers(
        -8, 9, 4096)).astype(np.float32))
    axis = ranks.RankMesh({"data": 4}, device).axis("data")
    return {"x": x, "all_reduce": ranks.all_reduce(x, axis),
            "reduce_scatter": ranks.reduce_scatter(x, axis),
            "gathered": ranks.all_gather(ranks.reduce_scatter(x, axis),
                                         axis).reshape(-1)}


@pytest.fixture(scope="module")
def four():
    return ranks.spawn(_rank_sums, ["cpu"] * 4, timeout=120)


def test_four_ranks_reduce_to_the_same_bits(four):
    first = four[0]["all_reduce"]
    for r in four:
        assert torch.equal(r["all_reduce"].view(torch.int32),
                           first.view(torch.int32))
        # each rank's block of the scattered sum, gathered whole, is the
        # same bits on every rank
        assert torch.equal(r["gathered"], four[0]["gathered"])
    blocks = torch.cat([r["reduce_scatter"] for r in four])
    assert torch.equal(blocks, four[0]["gathered"])
    want = torch.stack([r["x"] for r in four]).double().sum(0)
    np.testing.assert_allclose(first.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    np.testing.assert_allclose(blocks.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6 * float(want.abs().max()))
