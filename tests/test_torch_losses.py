"""PyTorch port, the matching and the loss: the batched Hungarian solver
against scipy (total cost, ties included; padded batches as the det
criterion builds them) and the JAX solver (tie-free costs), then ``hungarian_match`` and ``set_criterion`` (every key, aux
levels included, each point-loss kind) against the JAX package on the
same model outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from satellite_pose_estimation_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from satellite_pose_estimation_tpu.losses.criterion import set_criterion as jax_set_criterion
from satellite_pose_estimation_tpu.losses.matcher import hungarian_match as jax_hungarian_match
from satellite_pose_estimation_tpu.ops.hungarian import hungarian_batch as jax_hungarian_batch
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
from satellite_pose_estimation_tpu_torch.losses.matcher import hungarian_match
from satellite_pose_estimation_tpu_torch.ops.hungarian import hungarian


def _cost_of(cost, q4t):
    return cost[q4t, np.arange(cost.shape[1])].sum()


@pytest.mark.parametrize("Q,T", [(20, 11), (11, 11), (7, 1)])
def test_hungarian_total_cost_matches_scipy(Q, T):
    rng = np.random.RandomState(Q * 100 + T)
    costs = np.concatenate([rng.rand(8, Q, T),
                            rng.randint(0, 3, (8, Q, T)).astype(np.float64)])  # ties
    q4t = hungarian(torch.from_numpy(costs)).numpy()
    for cost, got in zip(costs, q4t):
        assert len(set(got.tolist())) == T  # a matching
        r, c = linear_sum_assignment(cost)
        np.testing.assert_allclose(_cost_of(cost, got), cost[r, c].sum(), rtol=1e-12)


PAD_B, PAD_Q, PAD_T = 5, 12, 7
PAD_COST = 0.0  # the det criterion's cost of a padded target


def _padded_case(seed, ties: bool):
    rng = np.random.RandomState(seed)
    shape = (PAD_B, PAD_Q, PAD_T)
    cost = rng.randint(0, 3, shape).astype(np.float64) if ties else rng.randn(*shape) * 3
    counts = rng.randint(0, PAD_T + 1, PAD_B)
    counts[0] = PAD_T  # one image without padding
    for b, n in enumerate(counts):
        cost[b, :, n:] = PAD_COST
    return cost, counts


def _scipy_real(cost, n):
    rows, cols = linear_sum_assignment(cost[:, :n])
    out = np.empty(n, np.int64)
    out[cols] = rows
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_hungarian_matches_scipy_on_padded_batches(seed, ties, dtype):
    """Padded as the det criterion pads (real targets first, the rest at a
    constant 0): on continuous costs scipy's query for every real target,
    on integer costs (ties) scipy's optimal total; float64 and float32."""
    cost, counts = _padded_case(seed, ties)
    got = hungarian(torch.tensor(cost, dtype=dtype)).numpy()
    for b, n in enumerate(counts):
        assert len(set(got[b])) == PAD_T
        want = _scipy_real(cost[b], n)
        total = cost[b, got[b, :n], np.arange(n)].sum()
        assert total == pytest.approx(cost[b, want, np.arange(n)].sum(), abs=1e-9)
        if not ties:
            assert (got[b, :n] == want).all()


def test_hungarian_assignment_matches_jax():
    costs = np.random.RandomState(0).rand(16, 20, 11).astype(np.float32)  # tie-free
    got = hungarian(torch.from_numpy(costs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hungarian_batch(jnp.asarray(costs))))


def _outputs(seed, B=3, Q=20, T=11, levels=3, sigmas=False):
    rng = np.random.RandomState(seed)

    def level():
        out = {"pred_logits": rng.randn(B, Q, 12).astype(np.float32) * 2.0,
               "pred_points": rng.rand(B, Q, 2).astype(np.float32)}
        if sigmas:
            out["pred_sigmas"] = rng.randn(B, Q, 2).astype(np.float32) * 0.5
        return out

    outputs = level()
    outputs["aux_outputs"] = [level() for _ in range(levels - 1)]
    targets = {"labels": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
               "landmarks": rng.rand(B, T, 2).astype(np.float32)}
    return outputs, targets


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(tree)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("use_focal", [False, True])
def test_hungarian_match_matches_jax(use_focal):
    out, tgt = _outputs(1)
    args = (out["pred_logits"], out["pred_points"], tgt["labels"], tgt["landmarks"])
    ref = jax_hungarian_match(*_jax_tree(list(args)), cost_class=2.0, cost_pts=5.0,
                              use_focal=use_focal)
    with torch.enable_grad():
        logits = torch.from_numpy(args[0]).requires_grad_()
        got = hungarian_match(logits, *_torch_tree(list(args[1:])), cost_class=2.0,
                              cost_pts=5.0, use_focal=use_focal)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["smooth_l1", "l1", "uncert"])
def test_set_criterion_matches_jax(kind):
    """Every key of the loss dict at float32 (1e-5: log-softmax and sums of
    60 terms in another order)."""
    out, tgt = _outputs(2, sigmas=kind == "uncert")
    jcfg = JaxCriterionConfig(point_loss=kind)
    cfg = CriterionConfig(point_loss=kind)
    ref_total, ref = jax_set_criterion(_jax_tree(out), _jax_tree(tgt), jcfg)
    total, losses = set_criterion(_torch_tree(out), _torch_tree(tgt), cfg)
    assert set(losses) == set(ref)
    assert {f"loss_ce_{i}" for i in range(2)} <= set(losses)
    for key, val in ref.items():
        np.testing.assert_allclose(losses[key].item(), float(val), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)


def test_set_criterion_gradient_reaches_every_level():
    out, tgt = _outputs(3)
    tout = _torch_tree(out)
    leaves = [tout["pred_logits"], tout["pred_points"]] + [
        t for aux in tout["aux_outputs"] for t in (aux["pred_logits"], aux["pred_points"])]
    for t in leaves:
        t.requires_grad_()
    total, _ = set_criterion(tout, _torch_tree(tgt), CriterionConfig())
    total.backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


def test_set_criterion_without_aux_and_cdn_raises():
    """Without ``aux_loss`` no aux level is scored; with ``dn_aux_outputs``
    and ``dn_meta`` (the CDN branch, once not ported and raising) every dn
    level is scored without a Hungarian, as JAX scores it (1e-5)."""
    out, tgt = _outputs(4)
    _, losses = set_criterion(_torch_tree(out), _torch_tree(tgt), CriterionConfig(aux_loss=False))
    assert "loss_ce_0" not in losses
    G, B = 2, 3
    dn = [_outputs(5 + i, Q=2 * G * 11, levels=1, sigmas=True)[0] for i in range(2)]
    out = dict(_outputs(4, sigmas=True)[0], dn_aux_outputs=dn)
    meta = {"dn_num_group": G, "dn_num_split": (2 * G * 11, 20)}
    cfg, jcfg = (C(point_loss="uncert", use_focal=True) for C in (CriterionConfig,
                                                                  JaxCriterionConfig))
    ref_total, ref = jax_set_criterion(dict(_jax_tree(out), dn_meta=meta), _jax_tree(tgt), jcfg)
    total, losses = set_criterion(dict(_torch_tree(out), dn_meta=meta), _torch_tree(tgt), cfg)
    assert set(losses) == set(ref) and {"loss_ce_dn_1", "loss_points_dn_1"} <= set(losses)
    for key, val in ref.items():
        np.testing.assert_allclose(losses[key].item(), float(val), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
