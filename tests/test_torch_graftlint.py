"""The repo's lint (scripts/graftlint) over the port's package.

The lint's default roots are the JAX package, the zoo and the scripts;
here it reads `elasticdl_tpu_torch/` with every rule.  GL-QUANT names
the one module allowed to do int8 plane arithmetic and the store seam
that moves raw planes by their JAX paths; for this run they point at the
port's twins of those modules (layers/arena.py, store/device.py).  The
other cases show the redirected rule still fires everywhere else in the
port, and GL-CLOCK on a stray wall-clock read.
"""

import pytest

from scripts.graftlint import core, rules_clock, rules_quant

PORT = "elasticdl_tpu_torch"
PORT_ARENA = f"{PORT}/layers/arena.py"
PORT_STORE_SEAM = f"{PORT}/store/device.py"

RAW_PLANE_MATH = "def f(planes):\n    return planes['q8'] * 2\n"
WALL_CLOCK_READ = (
    "import time\n"
    "class C:\n"
    "    def __init__(self, clock=time.time):\n"
    "        self._clock = clock\n"
    "    def due(self, t):\n"
    "        return time.time() >= t\n")


@pytest.fixture
def port_quant(monkeypatch):
    monkeypatch.setattr(rules_quant, "ARENA_MODULE", PORT_ARENA)
    monkeypatch.setattr(rules_quant, "STORE_ALLOWED_MODULES",
                        frozenset({PORT_STORE_SEAM}))


def test_the_port_has_no_findings(port_quant):
    project = core.build_project(core.REPO, [PORT])
    assert len(project.files) > 100
    findings = core.run_project(project)
    assert [f.format() for f in findings] == []


@pytest.mark.parametrize("rel, fires", [
    (PORT_ARENA, False),
    (PORT_STORE_SEAM, False),
    (f"{PORT}/layers/embedding.py", True),
    (f"{PORT}/store/tiered.py", True),
    ("elasticdl_tpu/layers/arena.py", True),
])
def test_raw_plane_math_is_allowed_only_in_the_port_arena_and_seam(
        port_quant, rel, fires):
    findings = core.check_source(RAW_PLANE_MATH, rel,
                                 [core.all_rules()[rules_quant.RULE_ID]])
    assert [f.rule for f in findings] == (
        [rules_quant.RULE_ID] if fires else [])


def test_a_wall_clock_read_beside_an_injected_clock_is_found():
    findings = core.check_source(WALL_CLOCK_READ,
                                 f"{PORT}/common/k8s_config.py",
                                 [core.all_rules()[rules_clock.RULE_ID]])
    assert [(f.line, f.rule) for f in findings] == [(6, rules_clock.RULE_ID)]
