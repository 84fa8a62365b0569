"""The port's YAML config loader against the JAX package's, over every
shipped ``configs/speed/*.yml`` and the synthetic self-check CLI's
config dict (JAX's as its ``main`` builds it): the merged dict, the dataloader,
criterion, train, augmentation and model settings, the compute dtype, the
lr schedule and the optimizer's parameter groups (names, lr, weight decay)
must be equal, exactly. Also the port's binary-PPM reader against PIL and
the merged-dict path (what the card's run hands the R2 CLI where PyYAML is
missing) against ``load_config``."""
import dataclasses
import pathlib
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig as JaxYAMLConfig
from satellite_pose_estimation_tpu.data import dataset as jax_dataset
from satellite_pose_estimation_tpu.train import optim as jax_optim
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.core.yaml_utils import load_config
from satellite_pose_estimation_tpu_torch.data.dataset import _decode
from satellite_pose_estimation_tpu_torch.models.detr import DETRKeypointModel
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR
from satellite_pose_estimation_tpu_torch.tools import synthetic_selfcheck as selfcheck
from satellite_pose_estimation_tpu_torch.train.state import make_optimizer

from _torch_parity import jax_selfcheck

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs/speed").glob("*.yml"))
STEPS_PER_EPOCH = 7


def _meta_model(cfg):
    """The config's model on the meta device (names and shapes, no weights)."""
    mcfg = cfg.model_config()
    with torch.device("meta"):
        return DETRKeypointModel(mcfg) if cfg.model_name == "DETR" else RTDETR(mcfg)


def _jax_groups(jcfg, names, monkeypatch):
    """{parameter name: (lr at step 0, weight decay, betas)} of the JAX
    package's ``build_tx`` on a tree with the port's parameter names, read
    from the per-group optimizer calls it makes, or None where it returns
    None."""
    kind = jcfg.yaml_cfg["optimizer"].get("type", "AdamW")
    calls, real = [], jax_optim.OPTIMIZERS[kind]

    def record(lr, **kw):
        calls.append((float(lr(0)) if callable(lr) else float(lr), kw))
        return real(lr, **kw)

    monkeypatch.setitem(jax_optim.OPTIMIZERS, kind, record)
    tree = {}
    for name in names:
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.zeros(1)
    if jcfg.build_tx(tree, STEPS_PER_EPOCH) is None:
        return None
    labels, _ = jax_optim.build_param_groups(jcfg.yaml_cfg["optimizer"]["params"], tree)
    out = {}
    for name in names:
        node = labels
        for part in name.split("."):
            node = node[part]
        lr, kw = calls[int(node[1:])]
        out[name] = (lr, kw.get("weight_decay", 0.0), tuple(kw.get("betas", (0.9, 0.999))))
    return out


def _port_groups(optimizer, model):
    ids = {id(p): n for n, p in model.named_parameters()}
    return {ids[id(p)]: (g["lr"], g["weight_decay"], tuple(g["betas"]))
            for g in optimizer.param_groups for p in g["params"]}


def _selfcheck_configs(case, monkeypatch):
    """The port's and JAX's ``YAMLConfig`` of the synthetic self-check CLI for
    ``case`` = "selfcheck-<preset>-<aug>": the port's from ``build_config``,
    JAX's as its ``main`` builds it (over a stand-in solver, in a temporary
    directory)."""
    _, preset, aug = case.split("-")
    with tempfile.TemporaryDirectory() as tmp:
        args = selfcheck.get_args_parser().parse_args([
            "--root", f"{tmp}/data", "--out", f"{tmp}/out", "--preset", preset, "--aug", aug,
            "--dtype", "bfloat16", "--ema", "--epochs", "3", "--lr", "1e-4"])
        jcfg, _, _ = jax_selfcheck(args, monkeypatch)
    return YAMLConfig(cfg=selfcheck.build_config(args)), jcfg


SELFCHECK_CASES = [f"selfcheck-{preset}-{aug}" for preset in ("small", "flagship")
                   for aug in ("full", "r1")]


@pytest.mark.parametrize("case", CONFIGS + SELFCHECK_CASES,
                         ids=lambda c: c.stem if isinstance(c, pathlib.Path) else c)
def test_config_reads_as_jax_reads_it(case, monkeypatch):
    """Every shipped speed config, and the self-check CLI's config dict for
    both presets and both ``--aug`` recipes, read the same by both
    packages (tests/test_torch_det_configs.py calls this on the det
    configs' paths)."""
    if isinstance(case, pathlib.Path):
        cfg, jcfg = YAMLConfig(str(case)), JaxYAMLConfig(str(case))
    else:
        cfg, jcfg = _selfcheck_configs(case, monkeypatch)
    _reads_as_jax(cfg, jcfg, monkeypatch)


def _reads_as_jax(cfg, jcfg, monkeypatch):
    """Hold the port's ``YAMLConfig`` to JAX's: the merged dict, the runtime
    options, the dataloader, criterion, train, augment and model configs,
    the lr schedule and the optimizer's groups on the model's parameter
    names (a meta-device model)."""
    assert cfg.yaml_cfg == jcfg.yaml_cfg
    for attr in ("task", "num_classes", "epoches", "checkpoint_step", "log_step", "output_dir",
                 "use_ema", "model_name"):
        assert getattr(cfg, attr) == getattr(jcfg, attr), attr
    assert cfg.compute_dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        jnp.dtype(jcfg.compute_dtype).name]
    for split in ("train", "val"):
        assert (dataclasses.asdict(cfg.dataloader_settings(split))
                == dataclasses.asdict(jcfg.dataloader_settings(split)))
    assert dataclasses.asdict(cfg.criterion_config()) == dataclasses.asdict(
        jcfg.criterion_config())
    assert dataclasses.asdict(cfg.train_config(STEPS_PER_EPOCH)) == dataclasses.asdict(
        jcfg.train_config(STEPS_PER_EPOCH))
    aug, jaug = cfg.augment_config(224), jcfg.augment_config(224)
    assert aug._fields == jaug._fields and tuple(aug) == tuple(jaug)

    mcfg, jmcfg = cfg.model_config(), jcfg.build_model().config
    for f in dataclasses.fields(mcfg):
        assert getattr(mcfg, f.name) == getattr(jmcfg, f.name), f.name

    sched, jsched = cfg.lr_schedule_fn(STEPS_PER_EPOCH), jcfg.lr_schedule_fn(STEPS_PER_EPOCH)
    milestones = (cfg.yaml_cfg.get("lr_scheduler") or {}).get("milestones", [])
    steps = {0, 1} | {m * STEPS_PER_EPOCH + d for m in milestones for d in (-1, 0, 1)}
    for step in sorted(steps):
        assert sched(step) == float(jsched(step)), step

    model = _meta_model(cfg)  # the MobileNetV3 / GhostNetV2 configs too (once they raised)
    if cfg.model_name == "RTDETR":
        assert type(model.backbone).__name__ == {"presnet": "PResNet", "ghostnetv2": "GhostNetV2"}.get(
            mcfg.backbone, "MobileNetV3")
    names = [n for n, _ in model.named_parameters()]
    tx, jgroups = cfg.build_tx(model, STEPS_PER_EPOCH), _jax_groups(jcfg, names, monkeypatch)
    if tx is None:
        # both fall back to TrainConfig's two-group AdamW: the backbone at
        # lr_backbone, the rest at lr, one weight decay
        assert jgroups is None
        tc = cfg.train_config(STEPS_PER_EPOCH)
        optimizer, _ = make_optimizer(tc, model)
        got = _port_groups(optimizer, model)
        assert got == {n: (tc.lr_backbone if n.startswith("backbone.") else tc.lr,
                           tc.weight_decay, tc.betas) for n in names}
    else:
        assert _port_groups(tx.optimizer, model) == jgroups
        assert tx.clip_max_norm == float(cfg.yaml_cfg.get("clip_max_norm", 0.1))


def test_ppm_frames_decode_as_pil_decodes_them(tmp_path):
    """A binary PPM (and PGM) frame read by the port's numpy reader equals
    PIL's decode of the same file, bit for bit; a header with a comment and
    a 16-bit file (left to PIL) included."""
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (21, 19)).astype(np.uint8)
    files = {
        "a.ppm": b"P6\n53 37\n255\n" + rgb.tobytes(),
        "b.ppm": b"P6 # made by a test\n53\n37 255\n" + rgb.tobytes(),
        "c.pgm": b"P5\n19 21\n255\n" + gray.tobytes(),
        "d.ppm": b"P6\n53 37\n65535\n" + rgb.astype(">u2").tobytes(),
    }
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        ref = np.asarray(Image.open(path).convert("RGB"))
        got = _decode(str(path))
        assert got.dtype == np.uint8 and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(got, jax_dataset._decode(str(path)), err_msg=name)
    Image.fromarray(rgb).save(tmp_path / "e.jpg", quality=90)
    np.testing.assert_array_equal(_decode(str(tmp_path / "e.jpg")),
                                  jax_dataset._decode(str(tmp_path / "e.jpg")))


def test_a_jpeg_without_pil_names_pil(tmp_path, monkeypatch):
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "f.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        _decode(str(tmp_path / "f.jpg"))


def test_merged_dict_path_equals_load_config():
    """The R2 recipe as one merged dict, as chip_smoke.py carries it for a
    machine without PyYAML, equals ``load_config`` of the file, and a
    ``YAMLConfig`` of it reads as one of the file does."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    path = ROOT / "configs/speed/rtdetr_r50vd_kl_1_512.yml"
    merged = chip_smoke.recipe_merged()
    assert merged == load_config(str(path))
    a, b = YAMLConfig(cfg=merged), YAMLConfig(str(path))
    assert a.yaml_cfg == b.yaml_cfg
    assert a.model_config() == b.model_config()
    assert a.criterion_config() == b.criterion_config()
    assert a.train_config(4) == b.train_config(4)


def test_chip_smoke_mobilenet_literals_equal_the_config_file():
    """chip_smoke.py's rtdetr_mobilenetv3_kl_1_512 literals (its phases
    21 and 24 run them where PyYAML is missing) merge to what load_config
    reads from the file."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    path = ROOT / "configs/speed/rtdetr_mobilenetv3_kl_1_512.yml"
    assert chip_smoke.mobilenet_merged() == load_config(str(path))
