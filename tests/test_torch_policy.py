"""The port's fault-policy engine (``repro_torch.policy``) against the
JAX package's, on the CPU: the same vocabulary and defaults, and the
policy-comparison campaign (``run_policy_matrix``, the 2-channel
all-reduce under each policy) giving the same matrix, every cell's
fingerprint and decision count included, and the same
``policy_dominance`` score."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import policy as JP  # noqa: E402
from repro import scenarios as J  # noqa: E402
from repro_torch import policy as TP  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402


def test_policy_vocabulary_and_defaults_equal_reference():
    assert TP.RESPONSES == JP.RESPONSES
    assert TP.FIXED_POLICIES == JP.FIXED_POLICIES
    assert TP.POLICIES == JP.POLICIES
    assert dataclasses.asdict(TP.PolicyConfig()) == \
        dataclasses.asdict(JP.PolicyConfig())
    with pytest.raises(ValueError, match="unknown policy"):
        TP.FaultPolicyEngine("bogus")


def test_policy_matrix_equals_reference():
    kw = dict(policies=("checkpoint", "adaptive"),
              scenario_names=("link_flap_train",), max_rounds=60,
              elems=1 << 10)
    port = T.run_policy_matrix(**kw)
    ref = J.run_policy_matrix(**kw)
    assert port == ref
    cells = [port[p]["link_flap_train"] for p in kw["policies"]]
    assert all(c["ok"] and c["decisions"] > 0 for c in cells)
    assert T.policy_dominance(port) == J.policy_dominance(ref)
