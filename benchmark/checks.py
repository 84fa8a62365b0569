"""How ``correct`` is decided: the numbers that hold what the timed path
produced against the plain reference, each beside the limit that
``limits/<cell>.json`` gives it, and the lower-precision control.

Eval cells: the reference runs its own warp and model in float32 (TF32 off)
on the inputs of every batch of the window that the seed samples, and its
solver and SPEED score on the program's points, probabilities and sigmas
(a pose solver's answer is not a continuous function of its points, so the
reference follows the program's points into the solver; the points are
checked by themselves). Each number is the widest gap over the sampled
images.

Train cells: the reference takes the program's first three steps from the
same weights, batches and augmentation draws (and, with dropout, the masks
the program drew) in float32, and each step's total loss, each leaf's
gradient norm as the optimizer received it at step 1, and each leaf's
change over the three steps are compared, by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""
from __future__ import annotations

import contextlib
import math

import harness
import inputs

BETA_FLOOR = 1e-3  # leaves whose reference gradient is below this share of the median leaf's


def limits(cell: str) -> dict:
    return harness.load_json(harness.HERE / "limits" / f"{cell}.json")["limits"]


def judge(numbers: dict, cell_limits: dict) -> list:
    """[{name, value, limit, ok}] for every number the cell's limits name, in
    their order; a number that is missing or not finite fails. Numbers the
    limits do not name are reported beside the verdict, not judged."""
    out = []
    for name, limit in cell_limits.items():
        value = numbers.get(name, float("nan"))
        ok = harness.finite(value) and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out


@contextlib.contextmanager
def float32_reference(torch):
    """TF32 off for the reference's matrix products and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- the lower-precision control -------------------------------------------

def fp8_control(torch):
    """A mode under which every convolution, linear layer and matrix product
    of the reference takes its floating-point operands rounded to fp8
    (e4m3, one scale per tensor, amax at 448) and computes in float32 on the
    rounded values; gradients pass straight through the rounding. The
    configurations state bf16 compute, so fp8 is the precision below."""
    from torch.overrides import TorchFunctionMode
    import torch.nn.functional as F

    e4m3 = torch.float8_e4m3fn
    fmax = torch.finfo(e4m3).max

    def q8(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().float().clamp_min(1e-30) / fmax
            r = (x.detach().float() / scale).to(e4m3).float() * scale
        return x + (r.to(x.dtype) - x).detach()

    ops = {F.conv2d, F.linear, torch.matmul, torch.bmm, torch.einsum, torch.Tensor.__matmul__,
           torch.mm, torch.baddbmm, torch.addmm}

    class Fp8(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in ops:
                if func is torch.einsum:
                    args = (args[0], *[q8(a) for a in args[1:]])
                elif func in (F.conv2d, F.linear):
                    args = (q8(args[0]), q8(args[1]), *args[2:])
                else:
                    args = tuple(q8(a) for a in args)
            return func(*args, **kwargs)

    return Fp8()


# -- dropout masks ----------------------------------------------------------

class DropoutRecorder:
    """Records the masks of every dropout the program draws in training
    while active: ``torch.nn.functional.dropout`` on a CUDA tensor is
    ``torch.native_dropout``'s output, so calling that and keeping its mask
    leaves the program's draws and results as they are (on the CPU, where
    the tests drive a run, the draws differ from ``dropout``'s own). Masks
    are kept bit-packed on the host."""

    def __init__(self, torch):
        self.torch = torch
        self.masks = []
        self._real = None

    def __enter__(self):
        torch = self.torch
        F = torch.nn.functional
        self._real = real = F.dropout

        def dropout(input, p=0.5, training=True, inplace=False):
            if not (training and 0.0 < p < 1.0 and input.numel() > 0):
                return real(input, p, training, inplace)
            out, mask = torch.native_dropout(input, p, True)
            self.masks.append((tuple(mask.shape), pack_bits(torch, mask)))
            if inplace:
                return input.copy_(out)
            return out

        F.dropout = dropout
        return self

    def __exit__(self, *exc):
        self.torch.nn.functional.dropout = self._real


class DropoutReplay:
    """Replays recorded masks, in order, for every dropout the reference
    draws while active. A mask recorded over fewer rows along one dimension
    (a side that took part of the batch) is repeated along it, so that the
    rows both sides hold get the same draws; a dropout with no recorded mask
    of a shape that fits draws its own, and the readings then show it."""

    def __init__(self, torch, masks, device):
        self.torch = torch
        self.masks = list(masks)
        self.device = device
        self._real = None

    def __enter__(self):
        torch = self.torch
        F = torch.nn.functional
        self._real = real = F.dropout

        def dropout(input, p=0.5, training=True, inplace=False):
            if not (training and 0.0 < p < 1.0 and input.numel() > 0):
                return real(input, p, training, inplace)
            if not self.masks:
                return real(input, p, training, inplace)
            shape, packed = self.masks.pop(0)
            dim = fitting_dim(shape, tuple(input.shape))
            if dim is None:  # the side followed drew for another batch
                return real(input, p, training, inplace)
            mask = unpack_bits(torch, packed.to(self.device), shape)
            if dim >= 0:
                reps = -(-input.shape[dim] // shape[dim])
                mask = torch.cat([mask] * reps, dim).narrow(dim, 0, input.shape[dim])
            return input * mask.to(input.dtype) * (1.0 / (1.0 - p))

        F.dropout = dropout
        return self

    def __exit__(self, *exc):
        self.torch.nn.functional.dropout = self._real


def fitting_dim(recorded: tuple, wanted: tuple):
    """-1 if a recorded mask's shape is the one wanted; the one dimension
    along which it holds fewer rows, all others equal; else None."""
    if recorded == wanted:
        return -1
    if len(recorded) != len(wanted):
        return None
    differ = [d for d, (r, w) in enumerate(zip(recorded, wanted)) if r != w]
    if len(differ) == 1 and recorded[differ[0]] < wanted[differ[0]]:
        return differ[0]
    return None


_BITS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bits(torch, mask):
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    w = torch.tensor(_BITS, dtype=torch.uint8, device=mask.device)
    return (flat.view(-1, 8).to(torch.uint8) * w).sum(-1, dtype=torch.uint8).cpu()


def unpack_bits(torch, packed, shape):
    w = torch.tensor(_BITS, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] & w) != 0
    return bits.reshape(-1)[:math.prod(shape)].view(shape)


# -- discrete choices the reference follows ----------------------------------

class Recorder:
    """Records what each call of ``module.<name>`` returns while active (the
    decoder's query selection ``topk``, the matcher's ``hungarian``)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.picks = []
        self._real = None

    def __enter__(self):
        self._real = real = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            self.picks.append(tuple(o.detach().clone() for o in out)
                              if isinstance(out, tuple) else out.detach().clone())
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._real)


def rows_like(picked, own):
    """``picked`` (a side's choices for the first rows of a batch, where it
    took fewer rows than ``own``) repeated along the batch to ``own``'s
    rows, as ``DropoutReplay`` repeats masks; else as it is."""
    if (picked.dim() == own.dim() and 0 < picked.shape[0] < own.shape[0]
            and picked.shape[1:] == own.shape[1:]):
        reps = -(-own.shape[0] // picked.shape[0])
        return picked.repeat(reps, *[1] * (picked.dim() - 1))[: own.shape[0]]
    return picked


class Follow:
    """Makes each call of ``module.<name>`` on the reference return the next
    of ``picks`` (another side's choices, as a ``Recorder`` kept them) and
    records, call by call, how much worse those choices are than the
    reference's own by the reference's own numbers (``gaps``)."""

    def __init__(self, module, name: str, picks):
        self.module, self.name = module, name
        self.picks = list(picks)
        self.gaps = []
        self._real = None

    def choose(self, args, own, picked):
        """(what the call returns, the gap of ``picked`` against ``own``)."""
        raise NotImplementedError

    def __enter__(self):
        self._real = real = getattr(self.module, self.name)

        def follow(*args, **kwargs):
            own = real(*args, **kwargs)
            if not self.picks:
                raise RuntimeError(f"the reference called {self.name} more often than the "
                                   f"side it follows")
            out, gap = self.choose(args, own, self.picks.pop(0))
            self.gaps.append(float(gap))
            return out

        setattr(self.module, self.name, follow)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._real)


class FollowTopk(Follow):
    """The decoder's query selection: the followed side's picks, in its
    order; the gap is the largest amount, over rows, by which the lowest
    reference score among them lies below the reference's own k-th best (0
    where the reference would pick the same set)."""

    def __init__(self, module, picks):
        super().__init__(module, "topk", [p[1] for p in picks])

    def choose(self, args, own, idx):
        scores = args[0]
        idx = rows_like(idx, own[1])
        if idx.shape != own[1].shape:  # the side followed selected for another batch
            return own, float("inf")
        idx = idx.to(scores.device)
        chosen = scores.detach().float().gather(1, idx)
        gap = (own[0].detach().float()[:, -1] - chosen.amin(1)).clamp_min(0.0).amax()
        return (scores.gather(1, idx), idx), gap


class FollowMatch(Follow):
    """The matcher's assignment: the followed side's matched query for each
    target; the gap is the largest amount, over images, by which its total
    cost under the reference's cost matrix exceeds the reference's own
    optimum."""

    def __init__(self, module, picks):
        super().__init__(module, "hungarian", picks)

    def choose(self, args, own, q4t):
        cost = args[0].detach()
        q4t = rows_like(q4t, own)
        if q4t.shape != own.shape:  # the side followed matched another batch
            return own, float("inf")
        q4t = q4t.to(cost.device)

        def total(assign):
            return cost.gather(1, assign[:, None, :]).squeeze(1).sum(-1)

        return q4t, (total(q4t) - total(own)).clamp_min(0.0).amax()


def watchers(torch, recipe) -> dict:
    """Recorders of what the reference must follow in a side's train steps:
    its dropout masks, its decoder's query selections, its matches."""
    out = {"match": Recorder(recipe.pkg.matcher, "hungarian")}
    if recipe.draws_dropout:
        out["dropout"] = DropoutRecorder(torch)
    if recipe.selector is not None:
        out["topk"] = Recorder(recipe.selector, "topk")
    return out


def followers(torch, recipe, watch: dict, device) -> dict:
    """The reference's side of ``watch``: replay and follow."""
    out = {}
    if "dropout" in watch:
        out["dropout"] = DropoutReplay(torch, watch["dropout"].masks, device)
    if "topk" in watch:
        out["topk"] = FollowTopk(recipe.selector, watch["topk"].picks)
    if "match" in watch:
        out["match"] = FollowMatch(recipe.pkg.matcher, watch["match"].picks)
    return out


# -- train readings -----------------------------------------------------------

def first_gradient_norms(torch, optimizer) -> dict:
    """{parameter id: norm of the gradient the optimizer received at its
    first step}, from Adam's first moment (1 - beta1) g."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "exp_avg" in st:
                out[id(p)] = st["exp_avg"].float().norm() / (1.0 - beta1)
    return out


def train_readings(torch, model, grad_norms: dict, losses: list, shapes, seed, device,
                   scaled=()) -> dict:
    """The program's (or a side's) readings after its first three steps:
    losses, per-leaf gradient norms at step 1 and per-leaf change norms
    from the seeded weights, by parameter name, on the host."""
    params = dict(model.named_parameters())
    change = {}
    for name, value in inputs.seeded_values(torch, shapes, seed, device, scaled):
        if name in params:
            change[name] = (params[name].detach().float() - value).norm()
    names = [n for n in params if n in change]
    grads = {n: grad_norms.get(id(params[n])) for n in names}
    return {
        "loss": [float(v) for v in losses],
        "grad": {n: (float(g) if g is not None else None) for n, g in grads.items()},
        "change": {n: float(change[n]) for n in names},
    }


def _leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """{leaf: |got - ref| / max(ref, median ref)} (a leaf with a value on one
    side only gives 1)."""
    names = [n for n in ref if keep is None or n in keep]
    vals = sorted(ref[n] for n in names if ref[n] is not None)
    median = vals[len(vals) // 2] if vals else 0.0
    out = {}
    for n in names:
        g, r = got.get(n), ref[n]
        if (g is None) != (r is None):
            out[n] = 1.0
        elif r is not None:
            out[n] = abs(g - r) / max(r, median, 1e-30)
    return out


def worst_leaves(gaps: dict, count: int = 5) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:count]


def train_numbers(got: dict, ref: dict, detail: dict | None = None) -> dict:
    """Each step's relative loss gap (loss_gap_1..3); the gradient norms of
    step 1 and the changes over the three steps by the worst leaf
    (grad_gap, change_gap) and by the median leaf (grad_gap_median,
    change_gap_median). Leaves whose reference gradient is below a
    thousandth of the median leaf's move by rounding alone under Adam and
    are left out of the change. ``detail``, if given, receives the worst
    leaves."""
    out = {f"loss_gap_{k + 1}": abs(g - r) / max(abs(r), 1e-30)
           for k, (g, r) in enumerate(zip(got["loss"], ref["loss"]))}
    grads = sorted(v for v in ref["grad"].values() if v is not None)
    median = grads[len(grads) // 2] if grads else 0.0
    keep = {n for n, v in ref["grad"].items() if v is not None and v >= BETA_FLOOR * median}
    for name, gaps in (("grad", _leaf_gaps(got["grad"], ref["grad"])),
                       ("change", _leaf_gaps(got["change"], ref["change"], keep))):
        vals = sorted(gaps.values())
        out[f"{name}_gap"] = vals[-1] if vals else 0.0
        out[f"{name}_gap_median"] = vals[len(vals) // 2] if vals else 0.0
        if detail is not None:
            detail[name] = worst_leaves(gaps)
    return out


# -- eval readings ------------------------------------------------------------

def _finite_gap(torch, gap, a, b) -> float:
    """The widest of ``gap`` over images where both sides' answers are
    finite; inf where only one side's is (an invalid pose is all zeros or
    NaN on both sides alike)."""
    fa = torch.isfinite(a.reshape(a.shape[0], -1)).all(-1)
    fb = torch.isfinite(b.reshape(b.shape[0], -1)).all(-1)
    if bool((fa != fb).any()):
        return float("inf")
    g = gap[fa & fb]
    return g.amax().item() if g.numel() else 0.0


def eval_numbers(torch, got: dict, ref: dict, solved: dict, score_ref) -> dict:
    """The widest gaps over the sampled images: points (in units of the crop
    box), probabilities, log-variances (sigma solvers), pose (the chord
    between the unit quaternions, sign-free, plus the relative translation,
    over every image; an invalid pose is zeros on both sides, and an image
    whose validity differs reads inf) and SPEED score. ``got``: the
    program's outputs; ``ref``: the reference model's; ``solved``: the reference solver's pose on the program's outputs;
    ``score_ref``: the reference score of the program's pose."""
    extent = (got["clip"][:, 2] - got["clip"][:, 0])[:, None, None]
    out = {
        "points_gap": ((got["points"] - ref["points"]).abs() / extent).amax().item(),
        "probs_gap": (got["probs"] - ref["probs"]).abs().amax().item(),
    }
    if got.get("sigmas_used"):
        out["sigmas_gap"] = (got["sigmas"].log() - ref["sigmas"].log()).abs().amax().item()
    dq = (got["quat"] - solved["quat"]).norm(dim=-1)
    ang = torch.minimum(dq, (got["quat"] + solved["quat"]).norm(dim=-1))
    rel = (got["tvec"] - solved["tvec"]).norm(dim=-1) / solved["tvec"].norm(dim=-1).clamp_min(1e-6)
    pose = torch.where(got["valid"] == solved["valid"], ang + rel, float("inf"))
    out["pose_gap"] = _finite_gap(torch, pose, got["quat"], solved["quat"])
    out["score_gap"] = _finite_gap(torch, (got["score"] - score_ref).abs(), got["score"],
                                   score_ref)
    return out


def over_batches(per: list) -> dict:
    """The numbers of several batches as one: the widest gap (a NaN
    anywhere stays)."""
    out = {}
    for name in per[0]:
        vals = [d[name] for d in per]
        if any(v != v for v in vals):
            out[name] = float("nan")
        else:
            out[name] = max(vals)
    return out
