"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names; the reference and the counts load nothing of the
measured program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'perfbench/tests')\n"
            "import torch; torch.set_num_threads(2)\n"
            "from tiny import run_tiny\n"
            "for cell in ('dtu-serve', 'tt-forward', 'dtu-train'):\n"
            "    run_tiny(cell, seconds=0.2, trace=cell == 'dtu-serve')\n"
            "from perfbench.harness import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()")
    loaded = _modules_after(code)
    assert "pointmvsnet_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "pointmvsnet_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import perfbench.reference.model, perfbench.reference.train, "
                            "perfbench.counts.flops, perfbench.counts.bounds, perfbench.check")
    assert not loaded & {"pointmvsnet_tpu_torch", "pointmvsnet_tpu", "jax", "flax"}


def test_forbidden_names_are_compared_whole():
    from perfbench import harness
    sys.modules["pointmvsnet_tpu_torch_lookalike"] = sys  # a name that only starts alike
    try:
        assert "pointmvsnet_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["pointmvsnet_tpu_torch_lookalike"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "dtu-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
