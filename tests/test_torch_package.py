"""The port's top-level names, resolved lazily as in the JAX package.

``det_sam2_tpu/__init__.py`` gives build_sam2, build_sam2_video_predictor,
build_sam2_engine, SAM2VideoPredictor, SAM2ImagePredictor and
SAM2AutomaticMaskGenerator through a module ``__getattr__``; the port's
package gives the same six. Each check runs in a fresh interpreter with JAX,
the JAX package, cv2 and PIL blocked: importing the package imports no
model code, torch's extension builder or a kernel, and each name is the
object of the module that defines it.
"""

import os
import subprocess
import sys

import pytest

import det_sam2_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {
    "build_sam2": "build", "build_sam2_video_predictor": "build",
    "build_sam2_engine": "build", "SAM2VideoPredictor": "video_predictor",
    "SAM2ImagePredictor": "image_predictor",
    "SAM2AutomaticMaskGenerator": "automatic_mask_generator",
}
BLOCKED = ("jax", "jaxlib", "flax", "optax", "det_sam2_tpu", "cv2", "PIL")


def _run(body: str) -> str:
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None  # an import of it raises\n"
        + body
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_same_names_as_the_jax_package():
    for name in NAMES:
        assert callable(getattr(det_sam2_tpu, name))


def test_import_loads_no_model_code():
    out = _run(
        "import det_sam2_tpu_torch\n"
        "print(' '.join(sorted(m for m, v in sys.modules.items() if v is not None "
        "and m.startswith(('det_sam2_tpu', 'torch')))))\n"
    )
    assert out.split() == ["det_sam2_tpu_torch"]


@pytest.mark.parametrize("name", sorted(NAMES))
def test_top_level_name_resolves_lazily(name):
    mod = NAMES[name]
    out = _run(
        "import det_sam2_tpu_torch as p\n"
        f"assert 'det_sam2_tpu_torch.{mod}' not in sys.modules\n"
        f"obj = p.{name}\n"
        "import importlib\n"
        f"assert obj is getattr(importlib.import_module('det_sam2_tpu_torch.{mod}'), "
        f"{name!r})\n"
        "from det_sam2_tpu_torch.ops import attention as att\n"
        "assert not att._LIBS  # no kernel was built or loaded\n"
        "print('torch.utils.cpp_extension' in sys.modules)\n"
    )
    assert out.split() == ["False"]


def test_unknown_name_raises_attributeerror():
    _run(
        "import det_sam2_tpu_torch as p\n"
        "try:\n"
        "    p.no_such_name\n"
        "except AttributeError as e:\n"
        "    assert 'no_such_name' in str(e)\n"
        "else:\n"
        "    raise SystemExit('no AttributeError')\n"
        "from det_sam2_tpu_torch import export, configs  # submodules still import\n"
    )
