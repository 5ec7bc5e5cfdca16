"""Float32 contractions whose results TF32 would change run at 'highest'
precision, read from the jaxprs (a GPU runs float32 dot_generals as TF32,
~3 decimal digits, unless the operation asks for more)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastslam_tpu.config import FastSLAMConfig

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """Every dot_general's precision in a closed jaxpr, nested ones too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def _graph():
    from tests.test_backend import simulate_world
    from fastslam_tpu.backend.builder import build_pose_graph

    noisy, obs, _ = simulate_world()[:3]
    return build_pose_graph(noisy, obs)


def _pose_graph_step():
    from fastslam_tpu.backend.pose_graph import gauss_newton_step

    g = _graph()
    return jax.make_jaxpr(lambda: gauss_newton_step(
        g.poses, g.landmarks, g, jnp.float32(1e-3)))()


def _line_filter():
    from fastslam_tpu.frontend.line_filter import line_filter

    pts = jnp.asarray(np.random.default_rng(0).normal(size=(180, 2)),
                      jnp.float32)
    # the default sigma (0.1 beams) is a 1-tap identity; 2 beams convolves
    cfg = FastSLAMConfig(line_filter_sigma=2.0)
    return jax.make_jaxpr(lambda p: line_filter(p, cfg))(pts)


@pytest.mark.parametrize("build", [_pose_graph_step, _line_filter],
                         ids=["pose_graph", "line_filter"])
def test_float32_contractions_run_at_highest_precision(build):
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "expected float32 contractions"
    for p in precisions:
        assert p == (HIGHEST, HIGHEST), p
