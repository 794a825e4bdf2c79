"""The chip command loads neither JAX nor the JAX package, and the
reference loads nothing of the program.  Module names are compared by
their top-level name (the part before the first dot), whole: the port's
name begins with the JAX package's."""

import json
import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "cronsun_tpu"}


def _modules(code: str, cwd=harness.ROOT) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=cwd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax(tiny):
    code = ("import portbench.__main__, portbench.calibrate\n"
            "from portbench import harness\n"
            f"for c in ('headline_steady', 'headline_common'):\n"
            f"    harness.run_cell(c, 5, 0.3, True, device='cpu', pkg={tiny!r})\n"
            "for m in harness.bench()['per_layer'] + "
            "harness.bench()['end_to_end']:\n"
            "    harness.reader(m['name'])\n")
    mods = _modules(code)
    tops = {m.partition(".")[0] for m in mods}
    assert "cronsun_tpu_torch" in tops          # the system under test ran
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import portbench.reference, portbench.gen, "
                    "portbench.roofline")
    tops = {m.partition(".")[0] for m in mods}
    assert not tops & (FORBIDDEN | {"cronsun_tpu_torch"}), tops


def test_the_harness_checks_what_is_loaded():
    import sys as _s
    assert harness.forbidden_modules() == sorted(
        m for m in _s.modules if m.partition(".")[0] in FORBIDDEN)
    _s.modules["cronsun_tpu.fake"] = _s.modules[__name__]
    try:
        assert harness.forbidden_modules() == ["cronsun_tpu.fake"]
    finally:
        del _s.modules["cronsun_tpu.fake"]
