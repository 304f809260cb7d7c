"""Nothing the benchmark runs loads JAX or the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import control, harness, judge, readers, reference, roofline
from portbench import scenes, trace
from portbench.judges import scene
from portbench.routes import resident
for m in harness.load_benchmark()["end_to_end"] + \
        harness.load_benchmark()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_the_harness_or_the_reference():
    out = subprocess.run([sys.executable, "-c", CODE, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, LOGFILE=os.devnull))
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "opticalimageprocessor_tpu_torch" in top
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "opticalimageprocessor_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    here = ROOT / "portbench"
    for path in [here / name for name in ("reference.py", "judge.py",
                                          "scenes.py", "roofline.py")] + \
            sorted((here / "judges").glob("*.py")):
        text = path.read_text()
        assert "opticalimageprocessor_tpu" not in text.replace(
            "opticalimageprocessor_tpu_torch", "")
        assert "import opticalimageprocessor_tpu_torch" not in text
        assert "from opticalimageprocessor_tpu_torch" not in text
