"""The port's controller runner on its Cartpole against the JAX package's on
its own, with the same seed and the same deterministic numpy policy.

Tolerance: states, actions and costs within 1e-5 (float32 RK4 steps of two
libraries, 40 steps); dones and episode lengths equal.
"""
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import envs as jenvs
from prob_mbrl_tpu.utils.apply_controller import apply_controller as j_apply
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch.utils.apply_controller import \
    apply_controller as t_apply


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(gain):
    def policy(x, t=0):
        return np.clip(gain * np.array([np.sin(x[0] + 0.3 * t) + x[2]]),
                       -10, 10)
    return policy


@pytest.mark.parametrize('gain,stop_when_done', [(0.5, True), (40.0, True),
                                                 (40.0, False)])
def test_apply_controller_matches_jax(gain, stop_when_done):
    runs = []
    for env, apply in ((jenvs.make('Cartpole'), j_apply),
                       (tenvs.make('Cartpole', device='cpu'), t_apply)):
        env.seed(4)
        runs.append(apply(env, _policy(gain), 40,
                          stop_when_done=stop_when_done))
    (js, ja, jc, jd, ji), (ts, ta, tc, td, ti) = runs
    assert len(ts) == len(js)
    assert list(td) == list(jd)
    if gain > 10 and stop_when_done:
        assert td[-1] and len(ts) < 40  # the cart leaves the track
    else:
        assert len(ts) == 40
    for got, ref in ((ts, js), (ta, ja), (tc, jc)):
        np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=0,
                                   atol=1e-5)
    assert [i['done'] for i in ti] == [i['done'] for i in ji]
    assert all(np.asarray(c).shape == (1,) for c in tc)
