"""The output check of the detection train cell, beside ``checks.py``
(whose train check drives the keypoint step): what the reference follows
of the program's first steps, and the recorders that capture it.

The reference takes the program's first three steps from the same seeded
weights and batches in float32 (TF32 off) and follows the program where
its choice is discrete or drawn: the CDN noise (``draw_denoising_noise``'s
draws, replayed), the encoder's top-k picks (``checks.FollowTopk``) and the
Hungarian matches of every matched level. Its own matcher is scipy's
(``spe_ref.losses.det_matcher``); ``match_gap`` is, over the first step's
levels and images, the largest amount by which the followed match's total
cost under the reference's cost exceeds scipy's optimum of that cost.

Since the reference follows the program's matches, a matcher that returns
a valid but worse assignment would pass every other number:
``match_opt_gap`` judges each assignment the program made in its first
steps against scipy's float64 optimum of the program's own costs, real
targets only, which no precision moves.
"""
from __future__ import annotations

import checks


class ReplayDraws:
    """Makes the reference's ``draw_denoising_noise`` return the draws the
    followed side made, call by call, each repeated over the rows the side
    left out of a part batch (``checks.rows_like``); draws of a shape that
    does not fit give way to the reference's own, and the readings then
    show it."""

    def __init__(self, module, draws):
        self.module = module
        self.draws = list(draws)
        self._real = None

    def __enter__(self):
        self._real = real = self.module.draw_denoising_noise

        def draw(*args, **kwargs):
            own = real(*args, **kwargs)
            if not self.draws:
                raise RuntimeError("the reference drew CDN noise more often than the side "
                                   "it follows")
            picked = [checks.rows_like(p.to(o.device), o)
                      for p, o in zip(self.draws.pop(0), own)]
            if any(p.shape != o.shape for p, o in zip(picked, own)):
                return own
            return tuple(picked)

        self.module.draw_denoising_noise = draw
        return self

    def __exit__(self, *exc):
        self.module.draw_denoising_noise = self._real


class FollowDetMatch(checks.Follow):
    """The matches of every matched level: ``det_matcher.assign(costs,
    mask)`` returns the followed side's (the program's (levels x B, T)
    stack, level by level, or a reference's (levels, B, T)); the gap is the
    largest excess of its total cost over scipy's optimum, over levels and
    images, on the reference's float64 costs of each image's real
    targets."""

    def __init__(self, module, picks):
        super().__init__(module, "assign", picks)

    def choose(self, args, own, picked):
        import torch
        costs, mask = args[0], args[1]
        L, B, T = own.shape
        picked = picked.reshape(L, -1, T)
        picked = torch.stack([checks.rows_like(p, o) for p, o in zip(picked, own)])
        if picked.shape != own.shape:  # the side followed matched another batch
            return own, float("inf")
        picked = picked.to(own.device)
        total = self.module.total_cost
        gap = 0.0
        for lv in range(L):
            for b in range(B):
                real = mask[b]
                gap = max(gap, total(costs[lv][b], picked[lv, b][real])
                          - total(costs[lv][b], own[lv, b][real]))
        return picked, gap


class MatchRecorder(checks.Recorder):
    """A ``checks.Recorder`` of a side's assignment solver that also keeps
    the arguments of each call: the program's (levels x B, Q, T) costs, or
    the reference's per-level, per-image costs and its (B, T) mask."""

    def __init__(self, module, name: str):
        super().__init__(module, name)
        self.args = []

    def __enter__(self):
        super().__enter__()
        spy = getattr(self.module, self.name)

        def keep(*args, **kwargs):
            self.args.append(tuple(a.detach().clone() if hasattr(a, "detach") else a
                                   for a in args))
            return spy(*args, **kwargs)

        setattr(self.module, self.name, keep)
        return self


def _real_problems(args, picks):
    """(cost (Q, n) float64, picks (n,)) over the real targets of every
    image and level of one recorded call."""
    import torch
    if len(args) == 1:  # the program: a padded target costs one constant over the queries
        cost = args[0].detach().to("cpu", torch.float64)
        picks = picks.to("cpu")
        for c, p in zip(cost, picks.reshape(cost.shape[0], -1)):
            real = (c != c[:1]).any(0)
            yield c[:, real].numpy(), p[real].numpy()
    else:  # the reference: real targets only, and the mask
        costs, mask = args[0], args[1].to("cpu")
        picks = picks.to("cpu")
        for lv, per_image in enumerate(costs):
            for b, c in enumerate(per_image):
                yield (c.detach().to("cpu", torch.float64).numpy(),
                       picks[lv, b][mask[b]].numpy())


def optimum_gap(recorder: MatchRecorder) -> float:
    """The largest excess, over the recorded calls, levels and images, of
    the side's assignment's total cost over scipy's optimum of the same
    costs in float64, real targets only, as a share of the optimum's
    absolute costs summed; 0 where every assignment is an optimum (ties
    included). An assignment that is not a permutation reads inf."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    gap = 0.0
    for args, picks in zip(recorder.args, recorder.picks):
        for cost, picked in _real_problems(args, picks):
            n = cost.shape[1]
            if n == 0:
                continue
            if len(set(picked.tolist())) != n:
                return float("inf")
            rows, cols = linear_sum_assignment(cost)
            best = cost[rows, cols]
            total = cost[picked, np.arange(n)].sum()
            gap = max(gap, (total - best.sum()) / max(np.abs(best).sum(), 1e-30))
    return float(gap)


def watchers(recipe) -> dict:
    """Recorders of what the reference follows in a side's train steps: its
    matches (with their costs), its decoder's query selections and, with
    CDN, its noise."""
    out = {"match": MatchRecorder(*recipe.match_site),
           "topk": checks.Recorder(recipe.selector, "topk")}
    if recipe.module.denoising(recipe.spec):
        out["draws"] = checks.Recorder(recipe.det.denoising, "draw_denoising_noise")
    return out


def followers(reference, watch: dict) -> dict:
    """The reference's side of ``watch``: replay and follow."""
    out = {"topk": checks.FollowTopk(reference.selector, watch["topk"].picks),
           "match": FollowDetMatch(reference.det.matcher, watch["match"].picks)}
    if "draws" in watch:
        out["draws"] = ReplayDraws(reference.det.denoising, watch["draws"].picks)
    return out
