"""The training step's CUDA graph (train/trainer.py: TrainStep).

On the CPU: the rule that decides whether a step replays
(``eager_reason``), each case once; what a batch signature tells apart; the
CPU step, which never replays, against a verbatim copy of the eager step
as it was before the graph, over three steps (losses, parameters, momentum
buffers and running statistics, bit for bit); the metrics of a step
unchanged by the next one; and how a device trace's kernels are told
apart as hand kernels' launches (``cuda.traced_launches``) and read over
several traces (``cuda.most_launches``), which is how a replay's launches
are counted, since a replay runs no kernel wrapper.

On the card (``cuda``): configs/sniper_res101_e2e.yml's detector at full
width and depth (its trunk in fp32, TF32 off, cuDNN deterministic), 16
uint8 chips of 512x512 a step over two batches in turn, each with fixed
sampler priorities. Three eager runs of 8 steps (a no-op forward hook
keeps a step eager) and one run of 3 eager steps then 5 replayed ones,
each from the same weights. The replayed run agrees with the first eager
run to within GAP_MULT times the eager runs' widest distance from one
another plus GAP_FLOOR, in the losses of every step, SGD's momentum
buffers, the BatchNorms' running statistics and the parameters after the
last step (X2 and P3 sum with atomics, so eager runs differ); 5 of its
steps replay (``eager_reason`` None), its replayed steps' traces hold the
hand-kernel launches of its eager steps' (the most of each over the
steps: the profiler can lose records), and the kernels' counters count
the eager steps and the capture and not the replays. From one saved state after
that run and one batch, one replayed step's gradients agree with one
eager step's to within GAP_MULT times two eager steps' distance plus
GAP_FLOOR. Then a batch of another signature (GT rows padded to 8, not 6) warms up for 3
steps and captures a second graph, and with the sampler's generator (no
priorities) and a learning rate of 0 two replays of one batch draw
different samples while two replays with fixed priorities agree.
"""

import copy
import itertools
import os

import pytest
import torch

from sniper_tpu_torch.models.detector import SNIPERDetector
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.models.losses import total_loss
from sniper_tpu_torch.models.norm import TrainBatchNorm
from sniper_tpu_torch.ops import cuda
from sniper_tpu_torch.parallel.distributed import global_count
from sniper_tpu_torch.train import trainer
from sniper_tpu_torch.train.optimizer import make_optimizer
from sniper_tpu_torch.infer.tester import device_normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a replayed run's distance from an eager run: at most GAP_MULT times two
# eager runs' own distance, plus GAP_FLOOR (relative)
GAP_MULT, GAP_FLOOR = 2.5, 1e-5

# ---------------------------------------------------------------------------
# the engagement rule
# ---------------------------------------------------------------------------

RULE_CASES = {
    # name: (on_cuda, in_group, hooked, eager_steps, reason starts with)
    "replays": (True, False, False, 3, None),
    "cpu_batch": (False, False, False, 3, "the batch is not on a CUDA"),
    "process_group": (True, True, False, 3, "a process group"),
    "forward_hook": (True, False, True, 3, "hooks on the model"),
    "warm_up": (True, False, False, 2, "warm-up: 2 of 3"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_eager_reason(case):
    *args, want = RULE_CASES[case]
    got = trainer.eager_reason(*args)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.startswith(want)


def _sig_batch(G=4):
    return {"data": torch.zeros(2, 8, 8, 3, dtype=torch.uint8),
            "gt_boxes": torch.zeros(2, G, 5),
            "im_info": torch.zeros(2, 3)}


SIGNATURE_CHANGES = {
    "shape": lambda b, p: ({**b, "gt_boxes": torch.zeros(2, 5, 5)}, p),
    "dtype": lambda b, p: ({**b, "data": b["data"].float()}, p),
    "key": lambda b, p: ({**b, "gt_masks": torch.zeros(2, 4, 7, 7)}, p),
    "generator_not_priorities": lambda b, p: (b, None),
    "priorities_shape": lambda b, p: (b, tuple(t[:, :3] for t in p)),
}


@pytest.mark.parametrize("change", list(SIGNATURE_CHANGES))
def test_signature_tells_apart(change):
    batch, pri = _sig_batch(), (torch.zeros(2, 5), torch.zeros(2, 5))
    sig = trainer.batch_signature(batch, pri)
    # the same keys in another order, other values: the same signature
    same = {k: torch.ones_like(v) for k, v in reversed(batch.items())}
    assert trainer.batch_signature(same, pri) == sig
    assert trainer.batch_signature(
        *SIGNATURE_CHANGES[change](batch, pri)) != sig


def test_observed_conditions():
    batch = _sig_batch()
    assert not trainer._on_cuda(batch, None)
    assert not trainer._on_cuda({"data": [1, 2]}, None)
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())
    assert not trainer._hooked(model.modules())
    for register in (lambda m: m.register_forward_hook(lambda *a: None),
                     lambda m: m.register_forward_pre_hook(lambda *a: None),
                     lambda m: m.register_full_backward_hook(
                         lambda *a: None)):
        h = register(model[1])
        try:
            assert trainer._hooked(model.modules())
        finally:
            h.remove()
    h = torch.nn.modules.module.register_module_forward_hook(
        lambda *a: None)
    try:
        assert trainer._hooked(model.modules())
    finally:
        h.remove()
    params = list(model.parameters())
    for register in (lambda p: p.register_hook(lambda g: g),
                     lambda p: p.register_post_accumulate_grad_hook(
                         lambda t: None)):
        h = register(params[0])
        try:
            assert trainer._hooked(model.modules(), params)
        finally:
            h.remove()
    assert not trainer._hooked(model.modules(), params)


# ---------------------------------------------------------------------------
# the CPU step, unchanged
# ---------------------------------------------------------------------------

TINY = dict(num_classes=5, num_anchors=9, anchor_scales=(2, 4, 7),
            anchor_ratios=(0.5, 1, 2), units=(1, 1, 1, 1),
            pre_nms_top_n=200, post_nms_top_n=16, train_pre_nms=200,
            train_post_nms=16, num_rois=20, dtype=torch.float32)
B, H, W, G = 2, 64, 64, 4
MEANS = (103.06, 115.9, 123.15)


def _cfg():
    from sniper_tpu_torch.config import default_config

    cfg = default_config()
    cfg.TRAIN.lr, cfg.TRAIN.warmup, cfg.TRAIN.warmup_lr = 0.01, True, 0.001
    cfg.TRAIN.warmup_step, cfg.TRAIN.lr_step = 2, "1.0"
    cfg.TRAIN.wd = 0.0005
    cfg.network.FIXED_PARAMS = ["conv0", "bn_data"]
    return cfg


def _tiny_batch(seed=21):
    g = torch.Generator().manual_seed(seed)
    n = 9 * (H // 16) * (W // 16)
    gt = torch.full((B, G, 5), -1.0)
    gt[0, :3] = torch.tensor([[4, 6, 40, 44, 1], [20, 10, 60, 30, 2],
                              [8, 30, 24, 50, 3]], dtype=torch.float32)
    gt[1, :3] = torch.tensor([[10, 12, 50, 58, 4], [2, 2, 22, 20, 1],
                              [30, 20, 62, 40, 2]], dtype=torch.float32)
    pids = torch.stack([torch.randperm(n, generator=g)[:32]
                        for _ in range(B)]).int()
    return {
        "data": torch.randint(0, 256, (B, H, W, 3), generator=g,
                              dtype=torch.uint8),
        "data_extent": torch.tensor([[H, W], [H - 8, W - 4]],
                                    dtype=torch.float32),
        "im_info": torch.tensor([[H, W, 1.0], [H - 8, W - 4, 1.0]]),
        "gt_boxes": gt,
        "valid_ranges": torch.tensor([[0.0, 1e5], [0.0, 40.0]]),
        "rpn_pids": pids,
        "rpn_label_vals": (torch.rand(B, 32, generator=g) < 0.3).float(),
        "fg_pids": pids[:, :8].contiguous(),
        "fg_targets": torch.randn(B, 8, 4, generator=g) * 0.2,
    }


def _old_step(model, optimizer, scheduler, batch_images, *, pixel_means,
              generator):
    """The eager step as make_train_step had it before the graph (one
    device, no OHEM, not RPN-only)."""

    def step(batch, priorities=None):
        data = device_normalize(batch["data"], batch["data_extent"],
                                pixel_means)
        model.train()
        out = model(data, batch["im_info"], batch["gt_boxes"],
                    batch["valid_ranges"], gt_masks=batch.get("gt_masks"),
                    train=True, generator=generator, priorities=priorities)
        loss, metrics = total_loss(out, batch, batch_images, 256)
        labels = out["rcnn_labels"]
        pred = out["cls_score"].detach().argmax(-1)
        valid = labels >= 0
        n_valid = global_count(valid.sum()).clamp_min(1)
        metrics["rcnn_acc"] = ((pred == labels) & valid).sum() / n_valid
        metrics["rcnn_fg_frac"] = (labels > 0).sum() / n_valid
        metrics.update(out["stats"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _tiny_run(make, steps=3):
    model = init_detector(SNIPERDetector(**TINY), seed=3)
    opt, sched, _ = make_optimizer(_cfg(), 100, model)
    step = make(model, opt, sched, B, pixel_means=MEANS,
                generator=torch.Generator().manual_seed(5))
    batch = _tiny_batch()
    metrics = [step(batch) for _ in range(steps)]
    return model, opt, metrics, step


def _state(model, opt):
    out = {f"param:{n}": p.detach().clone()
           for n, p in model.named_parameters()}
    out.update({f"momentum:{n}": opt.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters() if p in opt.state})
    out.update({f"stat:{n}": b.clone() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


def test_cpu_step_unchanged():
    """make_train_step on the CPU takes the same three steps, bit for bit,
    as the eager step it replaced; none of them replays."""
    model, opt, got, step = _tiny_run(trainer.make_train_step)
    ref_model, ref_opt, want, _ = _tiny_run(_old_step)
    assert step.eager_reason is not None and not step.graphs
    assert step.eager_reason.startswith("the batch is not on a CUDA")
    assert list(step.eager_steps.values()) == [3]
    for m, w in zip(got, want):
        assert m.keys() == w.keys()
        for k in w:
            assert torch.equal(m[k], w[k]), k
    a, b = _state(model, opt), _state(ref_model, ref_opt)
    assert a.keys() == b.keys()
    assert any(k.startswith("stat:") for k in a)
    assert any(k.startswith("momentum:") for k in a)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    # the training moved the leaves and the statistics
    fresh = init_detector(SNIPERDetector(**TINY), seed=3)
    moved = [n for n, p in fresh.named_parameters()
             if not torch.equal(p, a[f"param:{n}"])]
    assert moved and any(isinstance(m, TrainBatchNorm)
                         for m in model.modules())


def test_metrics_not_overwritten_by_next_step():
    model = init_detector(SNIPERDetector(**TINY), seed=3)
    opt, sched, _ = make_optimizer(_cfg(), 100, model)
    step = trainer.make_train_step(model, opt, sched, B, pixel_means=MEANS)
    batch = _tiny_batch()
    first = step(batch)
    kept = {k: v.clone() for k, v in first.items()}
    second = step(batch)
    assert not torch.equal(second["loss"], first["loss"])
    for k in kept:
        assert torch.equal(first[k], kept[k]), k


def _event(name, device=torch.autograd.DeviceType.CUDA, start=0.0):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start))


def test_traced_launches_by_symbol():
    """Each device kernel counts for the hand kernel whose symbol its
    name holds, the forward's and the backward's apart; host events and
    other kernels count for none."""
    from sniper_tpu_torch.ops import cuda

    events = [
        _event("void (anonymous namespace)::pool_pass_kernel<7>(float*)"),
        _event("pool_pass_bwd_kernel"), _event("pool_pass_bwd_kernel"),
        _event("void deform_im2col_bwd_kernel<__nv_bfloat16>(...)"),
        _event("nms_mask_kernel"), _event("nms_scan_kernel"),
        _event("void bn_unit_epilogue_kernel<1, false, true>(Args)"),
        _event("pool_pass_kernel", torch.autograd.DeviceType.CPU),
        _event("sm90_xmma_gemm_bf16bf16_bf16f32"),
        _event("Memcpy HtoD (Pageable -> Device)"),
        _event("sniper/graph"),
    ]
    assert cuda.traced_launches(events) == {
        "nms": 2, "deform_im2col": 0, "fused_pool": 1,
        "deform_im2col_bwd": 1, "fused_pool_bwd": 2, "roi_patch": 0,
        "unit_epilogue": 1}
    assert cuda.traced_launches([]) == dict.fromkeys(
        (k.name for k in cuda.KERNELS), 0)


def test_most_launches():
    """Each kernel's most over several traces' counts: a record lost in
    one trace does not lower it."""
    zero = dict.fromkeys((k.name for k in cuda.KERNELS), 0)
    a = {**zero, "nms": 6, "unit_epilogue": 8}
    b = {**zero, "nms": 5, "unit_epilogue": 10}
    assert cuda.most_launches([a, b]) == {**zero, "nms": 6,
                                          "unit_epilogue": 10}
    assert cuda.most_launches([]) == zero


def _kernel_names():
    from sniper_tpu_torch.ops import cuda

    return [k.name for k in cuda.KERNELS]


@pytest.mark.parametrize("name", _kernel_names())
def test_kernel_symbols_are_its_source_kernels(name):
    """A hand kernel's ``symbols`` are the ``__global__`` functions of its
    source, each of them, and no other kernel's symbol is part of one of
    its device kernels' names."""
    import re

    from sniper_tpu_torch.ops import cuda

    k = next(k for k in cuda.KERNELS if k.name == name)
    with open(os.path.join(ROOT, k.source)) as f:
        src = f.read()
    found = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                           r"\([^)]*\)\s*)?(\w+)\s*\(", src))
    assert found == set(k.symbols)
    assert cuda.traced_launches([_event(s) for s in k.symbols]) == {
        o.name: len(k.symbols) if o is k else 0 for o in cuda.KERNELS}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CHIPS, CHIP = 16, 512
EAGER_WARMUP, REPLAYED = trainer.GRAPH_WARMUP, 5


def _r101_cfg():
    from sniper_tpu_torch.config import load_config

    return load_config(os.path.join(ROOT, "configs", "sniper_res101_e2e.yml"))


def _r101_batch(cfg, model, seed, n_gt=6):
    """16 uint8 chips of 512x512, n_gt GT rows (the last one padding),
    sparse RPN targets, and fixed sampler priorities, on the host."""
    g = torch.Generator().manual_seed(seed)
    A, fh = cfg.network.NUM_ANCHORS, CHIP // cfg.network.RPN_FEAT_STRIDE
    gt = torch.full((CHIPS, n_gt, 5), -1.0)
    xy = torch.rand(CHIPS, n_gt - 1, 2, generator=g) * 300
    wh = 20 + torch.rand(CHIPS, n_gt - 1, 2, generator=g) * 180
    gt[:, :-1, :2], gt[:, :-1, 2:4] = xy, xy + wh
    gt[:, :-1, 4] = torch.randint(1, 81, (CHIPS, n_gt - 1),
                                  generator=g).float()
    pids = torch.stack([torch.randperm(A * fh * fh, generator=g)[:256]
                        for _ in range(CHIPS)]).int()
    batch = {
        "data": torch.randint(0, 256, (CHIPS, CHIP, CHIP, 3), generator=g,
                              dtype=torch.uint8),
        "data_extent": torch.full((CHIPS, 2), float(CHIP)),
        "im_info": torch.tensor([[CHIP, CHIP, 1.0]] * CHIPS),
        "gt_boxes": gt,
        "valid_ranges": torch.tensor([[0.0, 1e5]] * CHIPS),
        "rpn_pids": pids,
        "rpn_label_vals": (torch.rand(CHIPS, 256, generator=g) < 0.3).float(),
        "fg_pids": pids[:, :32].contiguous(),
        "fg_targets": torch.randn(CHIPS, 32, 4, generator=g) * 0.2,
    }
    n_cand = model.train_kw["post_nms"] + n_gt
    pri = tuple(torch.rand(CHIPS, n_cand, generator=g) for _ in range(2))
    return batch, pri


def _to(dev, batch, pri):
    return ({k: v.to(dev) for k, v in batch.items()},
            None if pri is None else tuple(p.to(dev) for p in pri))


def _launches():
    from sniper_tpu_torch.ops import cuda

    return {k.name: k.launches for k in cuda.KERNELS}


def _run(cfg, base, dev, inputs, *, steps, eager, lr_zero=False,
         generator=None, traced=False):
    """``steps`` steps of a fresh copy of ``base`` over ``inputs`` in
    turn (all eager with ``eager``: a no-op forward hook), each traced on
    its own with ``traced``; returns (each step's metrics on the host,
    each step's hand-kernel launches by the kernels' counters, the state
    after the last step, the step object, each step's eager reason, each
    traced step's hand-kernel launches in its trace)."""
    from sniper_tpu_torch.ops import cuda

    model = copy.deepcopy(base).to(dev)
    opt, sched, _ = make_optimizer(cfg, 1000, model)
    if lr_zero:
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 0.0)
    step = trainer.make_train_step(
        model, opt, sched, CHIPS, rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
        pixel_means=cfg.network.PIXEL_MEANS, generator=generator)
    hook = model.register_forward_hook(lambda *a: None) if eager else None
    metrics, launches, reasons, traces = [], [], [], []
    try:
        for k in range(steps):
            batch, pri = inputs[k % len(inputs)]
            before = _launches()
            if traced:
                m, got = cuda.traced_call(lambda: step(batch, pri))
                traces.append(got)
            else:
                m = step(batch, pri)
            torch.cuda.synchronize()
            launches.append({n: c - before[n]
                             for n, c in _launches().items()})
            metrics.append({n: float(v) for n, v in m.items()})
            reasons.append(step.eager_reason)
    finally:
        if hook is not None:
            hook.remove()
    return metrics, launches, _state(model, opt), step, reasons, traces


def _saved(model, opt):
    """The training state that a step reads and writes, copied."""
    return ([p.detach().clone() for p in model.parameters()],
            [b.clone() for b in model.buffers()],
            {p: opt.state[p]["momentum_buffer"].clone() for p in opt.state})


def _restore(model, opt, saved):
    """Copy ``saved`` back in place: a captured graph reads and writes the
    same tensors."""
    params, bufs, moms = saved
    with torch.no_grad():
        for p, v in zip(model.parameters(), params):
            p.copy_(v)
        for b, v in zip(model.buffers(), bufs):
            b.copy_(v)
        for p, v in moms.items():
            opt.state[p]["momentum_buffer"].copy_(v)


def _one_step_grads(step, saved, batch, pri, *, eager):
    """One step from ``saved`` (eager with ``eager``: a no-op forward
    hook): its eager reason and the gradients it left, copied."""
    _restore(step.model, step.optimizer, saved)
    hook = (step.model.register_forward_hook(lambda *a: None) if eager
            else None)
    try:
        step(batch, pri)
    finally:
        if hook is not None:
            hook.remove()
    torch.cuda.synchronize()
    return step.eager_reason, {
        f"grad:{n}": p.grad.detach().clone()
        for n, p in step.model.named_parameters() if p.grad is not None}


def _rel(a: dict, b: dict, prefix: str, base: dict | None = None) -> float:
    """Relative L2 distance of the ``prefix`` tensors of two states, all
    of them as one vector (of their change from ``base`` where given)."""
    num = den = 0.0
    for k in b:
        if not k.startswith(prefix):
            continue
        x, y = a[k].double(), b[k].double()
        if base is not None:
            x, y = x - base[k].double().to(x.device), \
                y - base[k].double().to(y.device)
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def _loss_gap(a: list, b: list) -> float:
    """The widest gap of a step's loss or loss term over the step's
    loss."""
    return max(abs(x[k] - y[k]) / abs(y["loss"])
               for x, y in zip(a, b) for k in y if k.endswith("loss"))


@pytest.fixture(scope="module")
def card_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    from sniper_tpu_torch.models.registry import get_model

    cfg = _r101_cfg()
    # an fp32 trunk, TF32 off and cuDNN's deterministic algorithms: in bf16
    # one rounding step apart early decorrelates every later one, and two
    # eager runs' parameters part by half their change over 8 steps
    cfg.TRAIN.bf16 = False
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        return _card_runs(cfg, dev, get_model)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _card_runs(cfg, dev, get_model):
    base = init_detector(get_model(cfg), seed=0)
    initial = {f"param:{n}": p.detach().clone()
               for n, p in base.named_parameters()}
    initial.update({f"stat:{n}": b.clone() for n, b in base.named_buffers()
                    if n.endswith(("running_mean", "running_var"))})
    inputs = [_to(dev, *_r101_batch(cfg, base, seed)) for seed in (1, 2)]
    steps = EAGER_WARMUP + REPLAYED
    out = {"initial": initial}
    for run in ("eager_a", "eager_b", "eager_c"):
        got = _run(cfg, base, dev, inputs, steps=steps, eager=True)
        out[run] = (*got[:3], None, *got[4:])  # the step object freed
        del got
        torch.cuda.empty_cache()
    out["graph"] = _run(cfg, base, dev, inputs, steps=steps, eager=False,
                        traced=True)
    out["replays"] = sum(r is None for r in out["graph"][4])
    # one step from one saved state and batch: eager, replayed, eager
    step = out["graph"][3]
    saved = _saved(step.model, step.optimizer)
    runs = [_one_step_grads(step, saved, *inputs[0], eager=e)
            for e in (True, False, True)]
    (r_a, a), (r_g, g), (r_b, b) = runs
    out["one_step"] = ([r_a, r_g, r_b], a.keys() == g.keys() == b.keys(),
                       _rel(g, a, "grad:"), _rel(b, a, "grad:"))
    del runs, a, g, b
    # a second signature on the same step object
    other = _to(dev, *_r101_batch(cfg, base, 3, n_gt=8))
    reasons = []
    for _ in range(EAGER_WARMUP + 1):
        step(*other)
        reasons.append(step.eager_reason)
    torch.cuda.synchronize()
    out["second"] = (reasons, len(step.graphs))
    # the sampler's generator at lr 0: two replays of one batch
    gen = torch.Generator(device=dev).manual_seed(11)
    drawn = _run(cfg, base, dev, [(inputs[0][0], None)],
                 steps=EAGER_WARMUP + 2, eager=False, lr_zero=True,
                 generator=gen)
    fixed = _run(cfg, base, dev, [inputs[0]], steps=EAGER_WARMUP + 2,
                 eager=False, lr_zero=True)
    out["generator"] = (drawn[0], drawn[4], fixed[0], fixed[4])
    print(f"\nstep graph on {torch.cuda.get_device_name(0)}: losses "
          + "; ".join(f"{n} " + ", ".join(f"{m['loss']:.6f}" for m in
                                          out[n][0])
                      for n in ("eager_a", "eager_b", "graph")))
    return out


@pytest.mark.cuda
def test_replayed_steps_match_eager(card_runs):
    a, g = card_runs["eager_a"], card_runs["graph"]
    eager = [card_runs[r] for r in ("eager_a", "eager_b", "eager_c")]
    pairs = list(itertools.combinations(eager, 2))
    init = card_runs["initial"]
    rows = {
        "losses": (_loss_gap(g[0], a[0]),
                   max(_loss_gap(y[0], x[0]) for x, y in pairs)),
        "momentum": (_rel(g[2], a[2], "momentum:"),
                     max(_rel(y[2], x[2], "momentum:") for x, y in pairs)),
        "running statistics": (
            _rel(g[2], a[2], "stat:", init),
            max(_rel(y[2], x[2], "stat:", init) for x, y in pairs)),
        "parameters": (
            _rel(g[2], a[2], "param:", init),
            max(_rel(y[2], x[2], "param:", init) for x, y in pairs)),
    }
    print("\nreplayed vs eager (relative), and the eager runs' widest: "
          + "; ".join(f"{k} {x:.3e} / {y:.3e}" for k, (x, y) in rows.items()))
    for k, (gap, spread) in rows.items():
        assert gap <= GAP_MULT * spread + GAP_FLOOR, (k, gap, spread)


@pytest.mark.cuda
def test_replays_counted_with_eager_launches(card_runs):
    """The replayed steps' traces hold the run's eager steps' hand-kernel
    launches (the most of each over the steps, since the profiler can
    lose records), which are the kernels the host launched; the kernels'
    counters count the eager steps and the capture, whose wrappers ran,
    and nothing for a replay."""
    a, g = card_runs["eager_a"], card_runs["graph"]
    assert card_runs["replays"] == REPLAYED
    assert g[4][:EAGER_WARMUP] == [
        f"warm-up: {k} of {EAGER_WARMUP} eager steps of the batch signature"
        for k in range(EAGER_WARMUP)]
    assert g[4][EAGER_WARMUP:] == [None] * REPLAYED
    want = cuda.most_launches(g[5][:EAGER_WARMUP])
    got = cuda.most_launches(g[5][EAGER_WARMUP:])
    print(f"\nhand kernels' launches in the eager steps' traces {want}, in "
          f"the replayed steps' {got}; each step's {g[5]}")
    assert got == want
    assert {n for n, c in want.items() if c} == {
        n for n, c in a[1][0].items() if c}
    hosted = EAGER_WARMUP + 1  # the eager steps, then the capture
    assert all(row == a[1][0] for row in a[1] + g[1][:hosted]), (a[1], g[1])
    assert all(not any(row.values()) for row in g[1][hosted:]), g[1]
    assert any(want.values())


@pytest.mark.cuda
def test_one_replayed_step_gradients_match_eager(card_runs):
    reasons, same_keys, gap, spread = card_runs["one_step"]
    print(f"\none step's gradients (relative): replayed vs eager {gap:.3e}, "
          f"eager vs eager {spread:.3e}")
    assert reasons == ["hooks on the model", None, "hooks on the model"]
    assert same_keys
    assert gap <= GAP_MULT * spread + GAP_FLOOR, (gap, spread)


@pytest.mark.cuda
def test_new_signature_captures_second_graph(card_runs):
    reasons, n_graphs = card_runs["second"]
    assert all(r.startswith("warm-up") for r in reasons[:EAGER_WARMUP])
    assert reasons[EAGER_WARMUP] is None and n_graphs == 2


@pytest.mark.cuda
def test_generator_draws_anew_each_replay(card_runs):
    drawn, drawn_reasons, fixed, fixed_reasons = card_runs["generator"]
    assert drawn_reasons[-2:] == [None, None] == fixed_reasons[-2:]
    # lr 0: the weights stay, so only the sampler's draws move the losses
    d = abs(drawn[-1]["rcnn_cls_loss"] - drawn[-2]["rcnn_cls_loss"])
    f = abs(fixed[-1]["rcnn_cls_loss"] - fixed[-2]["rcnn_cls_loss"])
    print(f"\nrcnn_cls_loss between two replays at lr 0: generator {d:.3e}, "
          f"fixed priorities {f:.3e}")
    assert d > 0 and d > 100 * f
