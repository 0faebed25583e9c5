"""The port's config, log and host-math helpers against the JAX package's,
on the cases of ``tests/test_utils.py``: the same calls to both packages'
``config``, ``utils.log`` and ``utils.mathx``; the same results, the same
exception (type name and message, the ``In <file>:<line>:`` call site
normalised), the same stderr lines. ``tests/test_torch_handler.py`` holds
the tensor math helpers (``torch_*`` against ``jnp_*``).
"""

import math

import numpy as np
import pytest

from egg_fluid_simulation_tpu import config as jcfg
from egg_fluid_simulation_tpu.utils import log as jlog
from egg_fluid_simulation_tpu.utils import mathx as jm
from egg_fluid_simulation_tpu_torch import config as tcfg
from egg_fluid_simulation_tpu_torch.utils import log as tlog
from egg_fluid_simulation_tpu_torch.utils import mathx as tm

import torch_twins as TW


def _same(fj, ft):
    """``fj()`` and ``ft()``: same result or same error, same stderr."""
    rj, ej, wj = TW.stderr_lines(fj)
    rt, et, wt = TW.stderr_lines(ft)
    assert wt == wj
    assert type(et).__name__ == type(ej).__name__, (et, ej)
    if ej is not None:
        assert TW.normalise(str(et)) == TW.normalise(str(ej))
    else:
        assert rt == rj or (isinstance(rj, float) and math.isnan(rj)
                            and math.isnan(rt)), (rt, rj)
    return rt, wt


HOST_MATH = [("clamp", (5, 0, 1)), ("clamp", (-5, 0, 1)),
             ("mix", (0.0, 10.0, 0.25)), ("mix2", (0, 0, 2, 4, 0.5)),
             ("wrap", (5, 4)), ("wrap", (4, 4)), ("wrap", (0, 0)),
             ("normalize2", (0.0, 0.0)), ("normalize2", (3.0, 4.0)),
             ("normalize2", (1e-12, 0.0))]


@pytest.mark.parametrize("name,args", HOST_MATH,
                         ids=[f"{n}{a}" for n, a in HOST_MATH])
def test_host_math_as_jax(name, args):
    """``test_clamp_mix_wrap`` and ``test_normalize_zero_vector_convention``."""
    _same(lambda: getattr(jm, name)(*args), lambda: getattr(tm, name)(*args))


LOG_CALLS = {
    "error": lambda log: log.error("boom ", 42),
    "warning": lambda log: log.warning("careful ", "now"),
    "types_ok": lambda log: log.assert_types(1, "number", {"a": 1}, "table",
                                             [1], "table"),
    "types_string": lambda log: log.assert_types("x", "number"),
    "types_bool": lambda log: log.assert_types(True, "number"),
    "types_odd": lambda log: log.assert_types(1, "number", 2),
}


@pytest.mark.parametrize("case", sorted(LOG_CALLS))
def test_log_as_jax(case):
    """``test_log_error_raises_with_callsite``, ``test_log_warning_to_stderr``
    and ``test_assert_types``: the error names its caller's file in both."""
    call = LOG_CALLS[case]
    _same(lambda: call(jlog), lambda: call(tlog))
    if case == "error":
        _, exc, _ = TW.stderr_lines(lambda: call(tlog))
        assert "test_torch_config_twins.py" in str(exc)


def test_config_defaults_as_jax():
    """``test_config_defaults_match_reference_values``."""
    assert tcfg.default_white_config() == jcfg.default_white_config()
    assert tcfg.default_yolk_config() == jcfg.default_yolk_config()
    assert tcfg.fluid_config() == jcfg.fluid_config()
    assert tcfg.CONFIG_SCHEMA == jcfg.CONFIG_SCHEMA


LOADS = {
    "unknown_key": [{"nonsense": 1.0}],
    "clamp": [{"damping": 2.0}, {"damping": -0.5}],
    "nan": [{"damping": float("nan")}],
    "wrong_type": [{"damping": "high"}, {"color": [1, 0, 0]},
                   {"color": [1, 0, 0, "x"]}],
    "colour_clamp": [{"color": [2.0, -1.0, 0.5, 1.0]}],
}


@pytest.mark.parametrize("case", sorted(LOADS))
@pytest.mark.parametrize("white", [True, False], ids=["white", "yolk"])
def test_load_config_as_jax(case, white):
    """``test_config_unknown_key_warns_and_ignores``,
    ``test_config_clamps_out_of_bounds_with_warning``,
    ``test_config_nan_ignored_with_warning``, ``test_config_wrong_type_fatal``
    and ``test_config_color_clamped``: each update leaves the same config,
    with the same warnings or error."""
    tj = jcfg.default_white_config() if white else jcfg.default_yolk_config()
    tt = tcfg.default_white_config() if white else tcfg.default_yolk_config()
    for upd in LOADS[case]:
        _same(lambda: jcfg.load_config(tj, dict(upd), white),
              lambda: tcfg.load_config(tt, dict(upd), white))
        assert tt == tj


def test_device_config_as_jax():
    """``test_device_config_roundtrip``: every field of the device config
    and of the stacked pair, shape and value."""
    pj = jcfg.stack_device_configs(
        jcfg.device_config_from_dict(jcfg.default_white_config()),
        jcfg.device_config_from_dict(jcfg.default_yolk_config()))
    pt = tcfg.stack_device_configs(
        tcfg.device_config_from_dict(tcfg.default_white_config()),
        tcfg.device_config_from_dict(tcfg.default_yolk_config()))
    names = [f for f in vars(pj)]
    assert sorted(names) == sorted(vars(pt))
    for f in names:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
