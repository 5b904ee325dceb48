"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU when asked for the card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[\s.,]|$)",
                       re.MULTILINE)

FIT_SCRIPT = """
import sys
import numpy as np
from repro_torch.core import SCRBConfig, SCRBModel, metrics
from repro_torch.data.synthetic import make_blobs
x, y = make_blobs(300, 4, 3, seed=0)
cfg = SCRBConfig(n_clusters=3, n_grids=16, sigma=1.5, d_g=256,
                 kmeans_replicates=1)
m = SCRBModel.fit(x, cfg, device="cpu")
assert m.predict(x[:50]).shape == (50,)
assert metrics.accuracy(m.fit_result.labels, y) > 0.9
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_cpu_fit_in_a_fresh_process_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", FIT_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core import SCRBConfig, SCRBModel, sc_rb
    x = np.zeros((30, 2), np.float32)
    cfg = SCRBConfig(n_clusters=2, n_grids=4, d_g=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRBModel.fit(x, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc_rb(x, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRBModel.load(str(ROOT / "tests" / "data" / "tiny_model_v1.npz"))
