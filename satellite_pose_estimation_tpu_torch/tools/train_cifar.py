"""CIFAR-10 classification sanity task (counterpart of tools/train_cifar.py;
the upstream R2 sanity-check task, R2/nn/arch/classification.py +
src/data/cifar10). Trains the MResNet classifier on CIFAR-10 batch files
already on disk, on the card unless ``--device cpu`` is asked for:

    python -m satellite_pose_estimation_tpu_torch.tools.train_cifar \
        --root /data/cifar-10-batches-py --epochs 5

AdamW with optax's defaults (beta 0.9 / 0.999, eps 1e-8, weight decay
1e-4 on every parameter), mean softmax cross-entropy, the JAX tool's
shuffle (``np.random.RandomState(seed)`` through ``CIFAR10.batches``) and
its epoch line. ``data.cifar10.write_synthetic_batches`` writes a
learnable stand-in set.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Optimizer:
    """``optax.adamw(lr, weight_decay=1e-4)``: every parameter decays (each
    gets a gradient here, so PyTorch's AdamW skips none)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(model, optimizer):
    """One optimizer step on (images (N, 32, 32, 3), labels (N,)) with the
    BatchNorms on batch statistics: returns (loss, accuracy) as device
    scalars, the accuracy of the logits before the update."""

    def train_step(images, labels):
        model.train()
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), (logits.detach().argmax(-1) == labels).float().mean()

    return train_step


@torch.inference_mode()
def eval_step(model, images, labels):
    """Accuracy with the BatchNorms on their running statistics."""
    model.eval()
    return (model(images).argmax(-1) == labels).float().mean()


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    """(images, labels) on ``device`` in one host-to-device copy: the
    labels (exact in float32) ride at the end of the image buffer."""
    n = len(labels)
    buf = torch.from_numpy(np.concatenate([images.reshape(-1), labels.astype(np.float32)]))
    if device.type == "cuda":
        buf = buf.pin_memory()
    buf = buf.to(device, non_blocking=True)
    return buf[:-n].view(images.shape), buf[-n:].long()


def main(args):
    from ..data.cifar10 import CIFAR10
    from ..models.classification import build_classification_model

    device = torch.device(args.device)
    train_ds = CIFAR10(args.root, train=True)
    test_ds = CIFAR10(args.root, train=False)
    model = build_classification_model(10, seed=args.seed, device=device)
    train_step = make_train_step(model, make_optimizer(model, args.lr))

    np_rng = np.random.RandomState(args.seed)
    history = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for images, labels in train_ds.batches(args.batch, np_rng):
            loss, acc = train_step(*to_device(images, labels, device))
            losses.append(loss)
            accs.append(acc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_seconds = time.perf_counter() - t0
        test_accs = [eval_step(model, *to_device(i, l, device))
                     for i, l in test_ds.batches(args.batch)]
        # one read-back an epoch: the per-step values, as the JAX tool averages them
        loss_v, acc_v, test_v = (torch.stack(v).double().cpu().numpy()
                                 for v in (losses, accs, test_accs))
        print(f"epoch {epoch}: loss {np.mean(loss_v):.4f} "
              f"train acc {np.mean(acc_v):.4f} test acc {np.mean(test_v):.4f}")
        history.append({"epoch": epoch, "losses": loss_v.tolist(), "train_acc": float(np.mean(acc_v)),
                        "test_acc": float(np.mean(test_v)), "train_images": len(loss_v) * args.batch,
                        "train_seconds": train_seconds})
    return {"model": model, "history": history}


def get_args_parser():
    parser = argparse.ArgumentParser("CIFAR-10 MResNet")
    parser.add_argument("--root", required=True)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
