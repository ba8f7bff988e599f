"""The reference's static analyzer (``tpunode.analysis``, source only) over
the port: every rule that applies to the port reports nothing.

The analyzer parses source and imports nothing of what it reads, so it runs
over ``tpunode_torch`` as it runs over ``tpunode``.  Three rules stay out:
``jit-cache-key`` is about ``jax.jit`` wrappers, which the port has none of,
and ``doc-drift`` and ``stale-doc`` hold telemetry names against
OBSERVABILITY.md, the reference's inventory, which does not list the port's
own spans (``verify.pack``).  ``raw-lock`` is among the rules that run: every
lock of the port is built through its own ``threadsan.lock`` so that it
joins the lock-order graph that ``threadsan.registry.arm()`` checks.
"""

from pathlib import Path

import pytest

from tpunode.analysis.core import RULES, Analyzer

PORT = Path(__file__).resolve().parents[1] / "tpunode_torch"
LEFT_OUT = ("jit-cache-key", "doc-drift", "stale-doc")
APPLIED = tuple(rule for rule in RULES if rule not in LEFT_OUT)


@pytest.fixture(scope="module")
def findings():
    """Every applied rule's findings over the port, one walk of its tree."""
    return Analyzer(select=APPLIED).check_paths([str(PORT)])


def test_the_left_out_rules_exist_and_raw_lock_applies():
    assert set(LEFT_OUT) <= set(RULES)
    assert "raw-lock" in APPLIED and len(APPLIED) == len(RULES) - len(LEFT_OUT)


@pytest.mark.parametrize("rule", APPLIED)
def test_port_has_no_finding_of_the_rule(findings, rule):
    found = [f.render() for f in findings if f.rule == rule]
    assert found == []


def test_no_finding_outside_the_applied_rules(findings):
    assert [f.render() for f in findings if f.rule not in APPLIED] == []


def test_raw_lock_flags_a_bare_lock_in_port_code():
    """The rule is live for the port's code: a bare lock in a module of the
    port's layout is a finding, the port's own ``threadsan.lock`` is not."""
    analyzer = Analyzer(select=["raw-lock"])
    bare = analyzer.check_source("import threading\n_lock = threading.Lock()\n",
                                 str(PORT / "verify" / "snippet.py"))
    named = analyzer.check_source('from .. import threadsan\n'
                                  '_lock = threadsan.lock("verify.snippet")\n',
                                  str(PORT / "verify" / "snippet.py"))
    assert [f.rule for f in bare] == ["raw-lock"] and named == []
