"""No module the benchmark runs loads JAX, jaxlib, flax or the JAX
package, compared by whole top-level names; the reference loads nothing
of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

from benchmark.run import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["mpmavatar_tpu_torch", "mpmavatar_tpu_torch.ops",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["mpmavatar_tpu.sim.solver", "numpy"]) == \
        ["mpmavatar_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jax", "jaxlib"]


def _loaded(imports: str) -> set:
    code = (f"import sys, json; {imports}; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_run_loads_no_jax():
    loaded = _loaded("import benchmark.run, benchmark.harness, "
                     "benchmark.control, benchmark.faults, "
                     "benchmark.drivers.sim_frames, "
                     "benchmark.drivers.material_step")
    assert "mpmavatar_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mpmavatar_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.mpm, "
                     "benchmark.reference.posing, "
                     "benchmark.reference.material, "
                     "benchmark.reference.scenes, benchmark.scenes")
    assert not loaded & {"jax", "jaxlib", "flax", "mpmavatar_tpu",
                         "mpmavatar_tpu_torch"}
