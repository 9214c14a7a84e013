"""The port's configuration registry (``repro_torch.configs.base``, its own
copy of ``repro.configs.base``) against the reference's, for every
architecture the reference names: the same config fields, block pattern,
head width, parameter counts, shapes and shape support."""
import dataclasses

import pytest

from repro.configs import base as jcb
from repro_torch.configs import base as tcb


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_config_matches_reference(arch, smoke):
    j, t = jcb.get(arch, smoke=smoke), tcb.get(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pattern == j.pattern
    assert t.head_dim == j.head_dim
    assert t.sub_quadratic == j.sub_quadratic
    assert t.active_params() == j.active_params()
    assert t.total_params() == j.total_params()
    for name, shape in jcb.SHAPES.items():
        assert dataclasses.asdict(tcb.SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert tcb.supports_shape(t, tcb.SHAPES[name]) == \
            jcb.supports_shape(j, shape)


def test_registry_lists_every_reference_arch():
    assert tcb.ARCH_IDS == jcb.ARCH_IDS
    assert tcb._MODULES == jcb._MODULES
    assert list(tcb.SHAPES) == list(jcb.SHAPES)
