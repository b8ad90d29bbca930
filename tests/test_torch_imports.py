"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro``.  Checked on the source (AST), so a lazy import inside a
function counts too."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")

pytestmark = pytest.mark.fast


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES
             if "src" in p.parts}
    for want in ("repro_torch/core/sweep.py", "repro_torch/core/group.py",
                 "repro_torch/kernels/smc_sweep.py",
                 "repro_torch/kernels/ops.py"):
        assert want in names
    assert (ROOT / "src/repro_torch/kernels/csrc/smc_sweep.cu").exists()


SERVE_MODULES = (
    "repro_torch.core.dds", "repro_torch.load.admission",
    "repro_torch.models.config", "repro_torch.models.layers",
    "repro_torch.models.runtime", "repro_torch.models.attention",
    "repro_torch.models.masking", "repro_torch.models.transformer",
    "repro_torch.models.registry", "repro_torch.models.convert",
    "repro_torch.configs", "repro_torch.serve.engine",
    "repro_torch.serve.fanout", "repro_torch.kernels.flash_decode",
    "repro_torch.kernels.rmsnorm", "repro_torch.kernels.ref",
    "repro_torch.api")


@pytest.mark.parametrize("module", SERVE_MODULES)
def test_serve_slice_modules_import_without_a_gpu(module):
    """Every module of the serve slice imports on a CPU-only machine:
    the CUDA build is reached only inside launches."""
    mod = importlib.import_module(module)
    assert mod.__name__ == module


def test_serve_slice_has_its_kernel_sources():
    decode = (ROOT / "src/repro_torch/kernels/csrc/flash_decode.cu"
              ).read_text()
    for kernel in ("flash_decode_split_kernel", "flash_decode_merge_kernel"):
        assert f"{kernel}(const Params p)" in decode
    assert 'extern "C" int flash_decode_launch' in decode
    cuda = (ROOT / "src/repro_torch/kernels/csrc/rmsnorm.cu").read_text()
    for fn in ("rms_norm_launch", "rms_norm_residual_launch"):
        assert f'extern "C" int {fn}' in cuda
    assert "rms_norm_residual_kernel(const Args a)" in cuda
    # every kernel of the port is CUDA: no Triton anywhere
    for path in PORT_FILES:
        src = path.read_text()
        assert "@triton.jit" not in src and "import triton" not in src, path


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


FORWARD_MODULES = (
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.selfcheck", "repro_torch.models.ssm",
    "repro_torch.configs.mamba2_2_7b", "repro_torch.train.steps",
    "repro_torch.models.moe", "repro_torch.models.vlm",
    "repro_torch.models.encdec", "repro_torch.configs.qwen2_moe_a2_7b",
    "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.internvl2_26b",
    "repro_torch.configs.seamless_m4t_medium")


@pytest.mark.parametrize("module", FORWARD_MODULES)
def test_forward_slice_modules_import_without_a_gpu(module):
    """The forward slice's modules import on a CPU-only machine: the CUDA
    builds are reached only inside launches."""
    mod = importlib.import_module(module)
    assert mod.__name__ == module


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan"])
def test_forward_slice_has_its_kernel_sources(name):
    src = (ROOT / f"src/repro_torch/kernels/csrc/{name}.cu").read_text()
    assert "__global__" in src and f'extern "C" int {name}_launch' in src


TRAIN_MODULES = (
    "repro_torch.tree", "repro_torch.kernels.quantize",
    "repro_torch.kernels.autograd", "repro_torch.core.gradsync",
    "repro_torch.optim.adamw", "repro_torch.data.pipeline",
    "repro_torch.train.checkpoint", "repro_torch.train.trainer")


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_slice_modules_import_without_a_gpu(module):
    """The training slice's modules import on a CPU-only machine: the
    quantize kernels' CUDA build is reached only inside launches."""
    mod = importlib.import_module(module)
    assert mod.__name__ == module


def test_train_slice_has_its_kernel_source():
    src = (ROOT / "src/repro_torch/kernels/csrc/quantize.cu").read_text()
    assert "__global__" in src
    for fn in ("quantize_launch", "dequantize_launch"):
        assert f'extern "C" int {fn}' in src
    # exactness: no fast-math build flag, no approximate division
    from repro_torch.kernels import _build
    assert not any("fast" in f for f in _build.NVCC_FLAGS)
    assert "__fdividef(" not in src and "rintf(" in src


FUSED_MODULES = (
    "repro_torch.core.graphloop", "repro_torch.serve.fused",
    "repro_torch.load", "repro_torch.load.arrivals",
    "repro_torch.load.profiles", "repro_torch.load.metrics",
    "repro_torch.load.harness")


@pytest.mark.parametrize("module", FUSED_MODULES)
def test_fused_slice_modules_import_without_a_gpu(module):
    """The fused serve program's and the load plane's modules import on a
    CPU-only machine: the IF-node helper's CUDA build is reached only
    inside a capture."""
    mod = importlib.import_module(module)
    assert mod.__name__ == module


DES_MODULES = (
    "repro_torch.core.simulator", "repro_torch.core.desgraph",
    "repro_torch.core.desreplay", "repro_torch.configs.spindle_smc")


@pytest.mark.parametrize("module", DES_MODULES)
def test_des_slice_modules_import_without_a_gpu(module):
    """The discrete-event simulator's modules are host code: they import
    on a CPU-only machine."""
    mod = importlib.import_module(module)
    assert mod.__name__ == module


def test_fused_slice_has_its_graph_source():
    src = (ROOT / "src/repro_torch/kernels/csrc/graph_cond.cu").read_text()
    assert "cudaGraphSetConditional" in src and "__global__" in src
    for fn in ("graph_if_begin", "graph_if_end", "graph_body_stream"):
        assert f'extern "C" int {fn}' in src
