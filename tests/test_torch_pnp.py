"""hslam_tpu_torch.ops.pnp against the JAX package with the JAX RANSAC draws
fed in (C3), and the recovery test of tests/test_pnp.py on the port's own
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.ops.pnp import solve_pnp as jpnp
from hslam_tpu_torch.io.synthetic import se3_exp_np
from hslam_tpu_torch.ops.pnp import solve_pnp as tpnp

torch.set_num_threads(1)

FX = FY = 150.0
CX, CY = 95.5, 63.5
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]], np.float32)


def _problem(seed=0, n=120, outlier_frac=0.25, noise=0.5):
    """tests/test_pnp.py's setup with numpy draws: points 3-8 m ahead, a
    known pose, pixel noise and a block of gross outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3.0, 8.0, n)], -1).astype(np.float32)
    R, t = se3_exp_np(np.array([0.2, -0.1, 0.15, 0.05, -0.08, 0.03]))
    Xc = X @ R.T + t
    obs = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    obs = obs + rng.normal(0, noise, obs.shape)
    n_out = int(n * outlier_frac)
    obs[:n_out] = rng.uniform(0, 150, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return X, obs.astype(np.float32), valid, R, t, n_out


@pytest.mark.parametrize("with_prior", [False, True], ids=["dlt_only", "with_prior"])
def test_solve_pnp_matches_with_jax_draws(with_prior):
    X, obs, valid, R, t, _ = _problem()
    key = jax.random.PRNGKey(9)
    probs = valid / valid.sum()
    samples = np.array(jax.random.choice(key, X.shape[0], shape=(64, 6), p=jnp.asarray(probs)))
    prior = {}
    if with_prior:
        # a prior pose a little off the truth, as relocalization passes in
        Rp, tp = se3_exp_np(np.array([0.21, -0.12, 0.13, 0.06, -0.07, 0.02]))
        prior = dict(init_R=Rp.astype(np.float32), init_t=tp.astype(np.float32))
    jr = jax.device_get(jpnp(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(valid),
                             jnp.asarray(K), key,
                             **{k: jnp.asarray(v) for k, v in prior.items()}))
    tr = tpnp(torch.from_numpy(X), torch.from_numpy(obs), torch.from_numpy(valid),
              torch.from_numpy(K), samples=torch.from_numpy(samples).long(),
              **{k: torch.from_numpy(v) for k, v in prior.items()})
    assert bool(jr.ok) and bool(tr.ok)
    np.testing.assert_array_equal(tr.inliers.numpy(), jr.inliers)
    # 11 GN steps from the same winning hypothesis on the same inlier set
    np.testing.assert_allclose(tr.R.numpy(), jr.R, atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), jr.t, atol=1e-4)


def test_pnp_recovers_pose_with_outliers():
    """tests/test_pnp.py::test_pnp_recovers_pose_with_outliers on the port's
    own draws (a torch.Generator seeded with the shell id)."""
    X, obs, valid, R_gt, t_gt, n_out = _problem(seed=3, noise=0.5)
    res = tpnp(torch.from_numpy(X), torch.from_numpy(obs), torch.ones(X.shape[0], dtype=torch.bool),
               torch.from_numpy(K), seed=9)
    assert bool(res.ok)
    dR = res.R.numpy() @ R_gt.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.02
    np.testing.assert_allclose(res.t.numpy(), t_gt, atol=0.08)
    assert int(res.inliers.numpy()[:n_out].sum()) < n_out // 4


def test_pnp_reports_failure_without_support():
    """Pure noise: no pose gathers min_inliers, so ok is False."""
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-2, 2, 60), rng.uniform(-1.5, 1.5, 60),
                  rng.uniform(3.0, 8.0, 60)], -1).astype(np.float32)
    obs = rng.uniform(0, 190, (60, 2)).astype(np.float32)
    res = tpnp(torch.from_numpy(X), torch.from_numpy(obs), torch.ones(60, dtype=torch.bool),
               torch.from_numpy(K), seed=1)
    assert not bool(res.ok)
