"""``Path`` of the PyTorch port against the JAX package's, bit for bit.

Each case of ``tests/test_path.py`` runs on both classes; every returned
value (tuples of floats, lists, numpy arrays) must be equal exactly, and
each error the JAX class raises the port's raises too.
"""

import numpy as np
import pytest

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.utils.log import SimulationError as JError
from egg_fluid_simulation_tpu_torch.utils.log import SimulationError as TError


def _at_endpoints_and_midpoint(P):
    p = P([0.0, 0.0, 10.0, 0.0])
    return [p.at(t) for t in (0.0, 1.0, 0.5, -1.0, 2.0, 0.3, 0.77)]


def _varargs_construction(P):
    p = P(0.0, 0.0, 4.0, 0.0)
    return [p.get_length(), p.at(0.25), p.get_points()]


def _degenerate_inputs(P):
    return [P([]).at(0.5), P([3.0, 4.0]).at(0.7), P().get_points()]


def _uniform_vs_arclength(P):
    pts = [0.0, 0.0, 1.0, 0.0, 11.0, 0.0]
    uniform = P(pts)
    arc = P(pts)
    arc.create_from_and_reparameterize(pts)
    ts = np.linspace(0.0, 1.0, 41)
    return [uniform.at(0.25), arc.at(0.5), uniform.at(ts), arc.at(ts)]


def _tangent_and_segment(P):
    p = P([0.0, 0.0, 1.0, 0.0, 1.0, 1.0])
    return [p.tangent_at(0.1), p.tangent_at(0.9), p.get_segment(0.9),
            p.get_segment_count(), p.tangent_at(np.linspace(0, 1, 9))]


def _override_parameterization(P):
    p = P([0.0, 0.0, 1.0, 0.0, 2.0, 0.0])
    p.override_parameterization(0.9, 0.1)
    return [p.at(0.45), p.at(np.linspace(0, 1, 21))]


def _resample_uniform_spacing(P):
    pts = [0.0, 0.0, 0.1, 0.0, 10.0, 0.0, 13.0, 4.0]
    p = P(pts)
    p.create_from_and_resample(pts)
    return [p.get_points(), p.get_length(), p.at(0.6)]


def _closest_point(P):
    p = P([0.0, 0.0, 10.0, 0.0])
    return [p.get_closest_point(5.0, 3.0),
            p.get_closest_point(5.0, 3.0, 0.6, 1.0),
            p.get_closest_point(5.0, 3.0, 1.0, 0.6)]


def _closest_point_on_closed_polygon(P):
    p = P([0.0, 0.0, 10.0, 0.0, 10.0, 10.0, 0.0, 10.0, 0.0, 0.0])
    return [p.get_closest_point(11.0, 5.0), p.get_closest_point(-3.0, 7.5),
            p.get_closest_point(4.0, 4.0, 0.3, 0.55)]


def _array_queries(P):
    p = P([0.0, 0.0, 10.0, 0.0])
    return [p.at(np.asarray([0.0, 0.5, 1.0]))]


def _get_length(P):
    return [P([0.0, 0.0, 3.0, 4.0]).get_length()]


def _demo_polygon(P):
    """The demo's random closed polygon, arc-length parameterized."""
    import math
    import random
    rng = random.Random(5)
    n = rng.randint(3, 7)
    off = rng.uniform(0, 2 * math.pi)
    pts = []
    for i in range(n):
        a = i / n * 2 * math.pi + off
        pts += [400 + math.cos(a) * 240, 300 + math.sin(a) * 240]
    pts += pts[:2]
    p = P([0.0, 0.0, 0.0, 0.0])
    p.create_from_and_reparameterize(pts)
    return [p.get_length(), p.at(np.linspace(0, 1, 97)),
            [p.at(t) for t in (0.0, 0.123, 0.5, 0.999)]]


CASES = {f.__name__.lstrip("_"): f for f in (
    _at_endpoints_and_midpoint, _varargs_construction, _degenerate_inputs,
    _uniform_vs_arclength, _tangent_and_segment, _override_parameterization,
    _resample_uniform_spacing, _closest_point,
    _closest_point_on_closed_polygon, _array_queries, _get_length,
    _demo_polygon)}


def _assert_identical(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_identical(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_path_bit_identical_to_jax(case):
    _assert_identical(CASES[case](T.Path), CASES[case](J.Path))


@pytest.mark.parametrize("call", [
    lambda P: P([0.0, 0.0, 1.0]),
    lambda P: P([0.0, 0.0, 1.0, 0.0, 2.0, 0.0]).override_parameterization(0.5),
    lambda P: P([0.0, 0.0, 1.0, 0.0, 2.0, 0.0]).override_parameterization(0.7, 0.7),
    lambda P: P([0.0, 0.0, 1.0, 0.0, 2.0, 0.0]).override_parameterization(1.2, -0.2),
], ids=["odd_coordinates", "wrong_count", "not_one", "negative"])
def test_path_errors_match_jax(call, capsys):
    with pytest.raises(JError) as ej:
        call(J.Path)
    with pytest.raises(TError) as et:
        call(T.Path)
    # the message without the call site, which names each package's file
    assert str(et.value).split(": ", 1)[-1] == str(ej.value).split(": ", 1)[-1]
