"""Tiny versions of the benchmark's configurations and traffic, for driving
a run on the CPU in seconds: the same recipes with a small trunk and narrow
widths, a small input and a batch of two (four in an eval sweep)."""
import copy

import harness

TRUNKS = {
    "detr_r50s8": {"DETR": {"backbone": "resnet18", "hidden_dim": 32, "nheads": 4,
                            "enc_layers": 1, "dec_layers": 2, "dim_feedforward": 64,
                            "num_queries": 12}},
    "rtdetr_r50vd_kl_512": {"RTDETR": {"depth": 18, "hidden_dim": 32, "nhead": 4,
                                       "dim_feedforward": 64, "num_queries": 12,
                                       "num_decoder_layers": 2}},
}


def config(name: str, input_size: int = 64, pack: int = 96) -> dict:
    spec = copy.deepcopy(harness.config_spec(name))
    for group, fields in TRUNKS[name].items():
        spec[group].update(fields)
    spec["input_size"], spec["pack_size"] = input_size, pack
    spec["flops_per_image"] = {"eval": 1.0, "train": 3.0}
    return spec


def traffic(name: str, batch: int = 2) -> dict:
    """The traffic ``name`` cut to ``batch`` images a batch; an eval sweep
    takes 4, since at two the tiny random model can answer both images
    alike and a batch read one row out of place would not show."""
    tr = copy.deepcopy(harness.traffic_spec(name))
    tr["batch"] = batch
    tr["pool"] = max(4, tr.get("pool", 4) // 2)
    if "check_batches" in tr:
        tr["check_batches"], tr["sample_span"] = 2, 1
        tr["batch"] = max(batch, 4)
    if "warmup" in tr:
        tr["warmup"] = 1
    return tr


def context(torch, cell: str, seed: int = 5, seconds: float = 0.2, limits=None):
    import run
    spec = harness.benchmark_spec()
    c = harness.find_cell(spec, cell)
    ctx = run.make_context(torch, torch.device("cpu"), cell, seed, seconds, False, 0.0,
                           spec=spec, config=config(c["config"]))
    ctx.traffic = traffic(c["traffic"])
    if limits is not None:
        ctx.limits = limits
    return ctx
