"""The inference forward's CUDA graph (main_test.make_forward: Forward).

On the CPU: the rule that decides whether a call replays
(``eager_reason``), each case once; the forward's own reading of its
input on a card's device (the kernels stubbed), each eager case and the
replay; what an input signature tells apart; and the CPU forward, which
never replays, against a verbatim copy of the forward as it was before the
graph (outputs and ``detector.MASK_ROIS`` bit for bit, a box and a mask
detector).

On the card (``cuda``): configs/sniper_res101_e2e.yml's detector and the
mask yml's at full width and depth with seeded weights, cuDNN
deterministic. Replayed outputs are bit for bit the eager ones (a no-op
forward hook keeps a call eager) for R101 at two canvas shapes and for the
mask yml's ``mask_prob``; a returned output is left unchanged by the next
replay; a forward pre-hook on ``model.mask`` keeps the call eager and
fires; ``MASK_ROIS`` after a replay equals the eager value at each of the
three test scales; and three canvases captured by one forward into its one
memory pool replay in any order, each bit for bit its eager outputs, the
earlier replays' outputs unchanged.
"""

import os

import pytest
import torch

from sniper_tpu_torch import main_test
from sniper_tpu_torch.infer.tester import device_normalize
from sniper_tpu_torch.models import detector
from sniper_tpu_torch.models.detector import SNIPERDetector
from sniper_tpu_torch.models.init import init_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEANS = (103.06, 115.9, 123.15)

# ---------------------------------------------------------------------------
# the engagement rule
# ---------------------------------------------------------------------------

RULE_CASES = {
    # name: (on_cuda, replicas, hooked, seen, reason starts with)
    "replays": (True, 1, False, True, None),
    "cpu_device": (False, 1, False, True, "the forward's device is not"),
    "replicas": (True, 2, False, True, "2 replicas"),
    "hooked": (True, 1, True, True, "hooks on the model"),
    "first_call": (True, 1, False, False, "the first call of the input"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_eager_reason(case):
    *args, want = RULE_CASES[case]
    got = main_test.eager_reason(*args)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.startswith(want)


SIGNATURE_CHANGES = {
    "data_shape": lambda d, i: (d[:, :8], i),
    "batch": lambda d, i: (d[:1], i[:1]),
    "data_dtype": lambda d, i: (d.float(), i),
    "data_device": lambda d, i: (d.to("meta"), i),
    "im_info_shape": lambda d, i: (d, i[:, :2]),
    "im_info_dtype": lambda d, i: (d, i.double()),
}


@pytest.mark.parametrize("change", list(SIGNATURE_CHANGES))
def test_signature_tells_apart(change):
    data = torch.zeros(2, 16, 24, 3, dtype=torch.uint8)
    info = torch.zeros(2, 3)
    sig = main_test.forward_signature(data, info)
    # other values of the same shape, dtype and device: the same signature
    assert main_test.forward_signature(torch.ones_like(data),
                                       info + 7) == sig
    assert main_test.forward_signature(
        *SIGNATURE_CHANGES[change](data, info)) != sig


class _Stubbed:
    """A forward whose device reads as a card's, its eager runs and its
    replays recorded in place of run."""

    def __init__(self, monkeypatch, replicas=1):
        model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())
        self.fwd = main_test.Forward([model] * replicas,
                                     [torch.device("cuda", 0)] * replicas,
                                     MEANS, None)
        self.model, self.ran = model, []

        def run(_self, replica, device, data, im_info):
            self.ran.append(("eager", tuple(data.shape)))
            return {"rois": torch.zeros(data.shape[0], 1, 5)}

        def replay(_self, sig, data, im_info):
            self.ran.append(("replay", tuple(data.shape)))
            return {}

        monkeypatch.setattr(main_test.Forward, "_run", run)
        monkeypatch.setattr(main_test.Forward, "_replay", replay)

    def __call__(self, b=2):
        self.fwd(torch.zeros(b, 4, 4, 3, dtype=torch.uint8),
                 torch.zeros(b, 3))
        return self.fwd.eager_reason, self.ran[-1][0]


def test_forward_reads_its_input(monkeypatch):
    """On a card's device: a signature's first call, a module hook and a
    global hook run eagerly, with their reasons; a seen signature
    replays; a new shape is a first call again."""
    s = _Stubbed(monkeypatch)
    reason, how = s()
    assert how == "eager" and reason.startswith("the first call")
    assert s() == (None, "replay")
    for register in (lambda: s.model[1].register_forward_pre_hook(
                         lambda *a: None),
                     lambda: s.model[0].register_forward_hook(
                         lambda *a: None),
                     lambda: torch.nn.modules.module
                     .register_module_forward_hook(lambda *a: None)):
        h = register()
        try:
            reason, how = s()
            assert how == "eager" and reason == "hooks on the model"
        finally:
            h.remove()
    assert s() == (None, "replay")
    reason, how = s(b=4)
    assert how == "eager" and reason.startswith("the first call")
    assert s(b=4) == (None, "replay")


def test_forward_over_replicas_stays_eager(monkeypatch):
    """Over two replicas on a card's device every call of a signature
    takes the eager split (here refused at once: 3 images do not split
    in two), never the replay."""
    s = _Stubbed(monkeypatch, replicas=2)
    for _ in range(3):
        with pytest.raises(ValueError, match="not divisible by 2"):
            s(b=3)
        assert s.fwd.eager_reason.startswith("2 replicas")
    assert not s.ran


# ---------------------------------------------------------------------------
# the CPU forward, unchanged
# ---------------------------------------------------------------------------

TINY = dict(num_classes=5, num_anchors=9, anchor_scales=(2, 4, 7),
            anchor_ratios=(0.5, 1, 2), units=(1, 1, 1, 1),
            pre_nms_top_n=200, post_nms_top_n=16, dtype=torch.float32)
B, H, W = 2, 64, 96


def _old_forward(model, device, pixel_means, post_nms_top_n=None):
    """make_forward's one-device forward as it was before the graph."""
    model.to(device).eval()

    @torch.inference_mode()
    def forward(data, im_info):
        data = torch.as_tensor(data)
        im_info = torch.as_tensor(im_info, dtype=torch.float32)
        data = data.to(device, non_blocking=True)
        im_info = im_info.to(device)
        data = device_normalize(data, im_info, pixel_means)
        return model(data, im_info, post_nms_top_n=post_nms_top_n)

    return forward


def _tiny_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (B, H, W, 3), generator=g,
                         dtype=torch.uint8)
    info = torch.tensor([[H, W, 1.0], [H - 8, W - 16, 1.0]])
    return data.numpy(), info.numpy()


@pytest.mark.parametrize("with_mask", [False, True])
def test_cpu_forward_unchanged(with_mask):
    """make_forward on the CPU returns, call after call of one signature,
    the outputs of the forward it replaced bit for bit, and leaves
    MASK_ROIS as it did; no call replays."""
    model = init_detector(SNIPERDetector(**TINY, with_mask=with_mask),
                          seed=3, offset_std=1e-3)
    cpu = torch.device("cpu")
    fwd = main_test.make_forward(model, None, cpu, MEANS, post_nms_top_n=12)
    old = _old_forward(model, cpu, MEANS, post_nms_top_n=12)
    keys = {"rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred"}
    for seed in (1, 2, 3):
        inputs = _tiny_inputs(seed)
        detector.MASK_ROIS = -1
        got = fwd(*inputs)
        got_rois = detector.MASK_ROIS
        detector.MASK_ROIS = -1
        want = old(*inputs)
        assert got_rois == detector.MASK_ROIS == (B * 12 if with_mask
                                                  else 0)
        assert set(got) == set(want) == keys | ({"mask_prob"} if with_mask
                                                else set())
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert fwd.eager_reason.startswith("the forward's device is not")
    assert not fwd.graphs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_model(yml):
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models.registry import get_model

    cfg = load_config(os.path.join(ROOT, "configs", yml))
    model = init_detector(get_model(cfg), seed=0, offset_std=1e-3)
    return cfg, model.to("cuda").eval()


def _canvases(b, h, w, seed, n=1):
    """``n`` uint8 batches of b canvases h x w on the card, with im_info
    whose extents differ per image."""
    g = torch.Generator().manual_seed(seed)
    info = torch.tensor([[h - 16 * i, w - 8 * i, 1.0] for i in range(b)],
                        device="cuda")
    return [(torch.randint(0, 256, (b, h, w, 3), generator=g,
                           dtype=torch.uint8).to("cuda"), info)
            for _ in range(n)]


def _eager(fwd, model, data, info):
    """``fwd`` on one batch, kept eager by a no-op forward hook."""
    h = model.register_forward_hook(lambda *a: None)
    try:
        out = fwd(data, info)
    finally:
        h.remove()
    assert fwd.eager_reason == "hooks on the model"
    return out


def _same(a: dict, b: dict) -> dict:
    return {k: torch.equal(a[k], b[k]) for k in b}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flag


@pytest.fixture(scope="module")
def r101(card):
    return _card_model("sniper_res101_e2e.yml")


@pytest.fixture(scope="module")
def r101_mask(card):
    return _card_model("sniper_res101_e2e_mask.yml")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 384, 512), (4, 512, 640)])
def test_replay_matches_eager(r101, shape):
    """A signature's first call runs eagerly, its second captures and
    replays, its third replays: each bit for bit the eager outputs, and
    the returned outputs are not the graph's own tensors."""
    cfg, model = r101
    fwd = main_test.make_forward(model, None, "cuda", cfg.network.PIXEL_MEANS,
                                 post_nms_top_n=200)
    (x, info), = _canvases(*shape, seed=sum(shape))
    first = fwd(x, info)
    assert fwd.eager_reason.startswith("the first call")
    captured = fwd(x, info)
    assert fwd.eager_reason is None and len(fwd.graphs) == 1
    replayed = fwd(x, info)
    assert fwd.eager_reason is None and len(fwd.graphs) == 1
    eager = _eager(fwd, model, x, info)
    torch.cuda.synchronize()
    (graph,) = fwd.graphs.values()
    assert all(replayed[k].data_ptr() != graph.outputs[k].data_ptr()
               for k in graph.outputs)
    assert bool(first["roi_valid"].any())
    for got in (first, captured, replayed):
        assert _same(got, eager) == dict.fromkeys(eager, True)


@pytest.mark.cuda
def test_mask_replay_matches_eager(r101_mask):
    cfg, model = r101_mask
    fwd = main_test.make_forward(model, None, "cuda", cfg.network.PIXEL_MEANS,
                                 post_nms_top_n=100)
    (x, info), = _canvases(2, 384, 512, seed=5)
    for _ in range(3):
        replayed = fwd(x, info)
    assert fwd.eager_reason is None
    eager = _eager(fwd, model, x, info)
    torch.cuda.synchronize()
    assert replayed["mask_prob"].shape == (2, 100, 28, 28)
    assert _same(replayed, eager) == dict.fromkeys(eager, True)


@pytest.mark.cuda
def test_output_survives_next_replay(r101):
    cfg, model = r101
    fwd = main_test.make_forward(model, None, "cuda", cfg.network.PIXEL_MEANS,
                                 post_nms_top_n=100)
    (a, info), (b, _) = _canvases(2, 384, 512, seed=7, n=2)
    fwd(a, info)
    out_a = fwd(a, info)
    kept = {k: v.clone() for k, v in out_a.items()}
    out_b = fwd(b, info)
    assert fwd.eager_reason is None
    torch.cuda.synchronize()
    assert _same(out_a, kept) == dict.fromkeys(kept, True)
    assert not torch.equal(out_b["cls_prob"], out_a["cls_prob"])


@pytest.mark.cuda
def test_mask_pre_hook_keeps_forward_eager(r101_mask):
    """A forward pre-hook on the mask head, as the benchmark's mask pyramid
    sets one, keeps a captured signature's call eager, fires once, and the
    call's outputs are the replay's."""
    cfg, model = r101_mask
    fwd = main_test.make_forward(model, None, "cuda", cfg.network.PIXEL_MEANS,
                                 post_nms_top_n=100)
    (x, info), = _canvases(2, 384, 512, seed=9)
    fwd(x, info)
    replayed = fwd(x, info)
    pooled = []
    h = model.mask.register_forward_pre_hook(
        lambda _m, args: pooled.append(args[0]))
    try:
        hooked = fwd(x, info)
    finally:
        h.remove()
    assert fwd.eager_reason == "hooks on the model"
    assert len(pooled) == 1 and pooled[0].shape[0] == 2 * 100
    torch.cuda.synchronize()
    assert _same(hooked, replayed) == dict.fromkeys(replayed, True)


@pytest.mark.cuda
def test_mask_rois_after_replay(r101_mask):
    """At each of the mask yml's test scales, with its batch and post-NMS
    count: MASK_ROIS after a replay is the eager call's, B x N."""
    from sniper_tpu_torch.data.test_loader import canvas_for_scale

    cfg, model = r101_mask
    for s, spec in enumerate(cfg.TEST.SCALES):
        (ch, cw), _ = canvas_for_scale(spec)
        b = int(cfg.TEST.BATCH_IMAGES[s])
        n = int(cfg.TEST.N_PROPOSAL_PER_SCALE[s])
        fwd = main_test.make_forward(model, None, "cuda",
                                     cfg.network.PIXEL_MEANS, n)
        (x, info), = _canvases(b, ch, cw, seed=s)
        fwd(x, info)
        eager = detector.MASK_ROIS
        detector.MASK_ROIS = -1
        fwd(x, info)
        captured = detector.MASK_ROIS
        detector.MASK_ROIS = -1
        fwd(x, info)
        assert fwd.eager_reason is None
        assert eager == captured == detector.MASK_ROIS == b * n, s


@pytest.mark.cuda
def test_shared_pool_replays_in_any_order(r101):
    """One forward, three canvases (three graphs in its one pool), two
    batches each: replayed in an order unlike the captures', each output
    bit for bit the eager one, and every output held to the end unchanged
    by the replays after it."""
    cfg, model = r101
    fwd = main_test.make_forward(model, None, "cuda", cfg.network.PIXEL_MEANS,
                                 post_nms_top_n=100)
    shapes = [(4, 512, 640), (8, 320, 448), (8, 192, 256)]
    inputs = [_canvases(*sh, seed=20 + i, n=2) for i, sh in enumerate(shapes)]
    for batches in inputs:
        for x, info in batches:
            fwd(x, info)  # the first call eager, the second captures
    assert len(fwd.graphs) == 3
    assert {g.graph.pool() for g in fwd.graphs.values()} == {fwd.pool}
    eager = {(s, j): _eager(fwd, model, *inputs[s][j])
             for s in range(3) for j in range(2)}
    order = [(2, 0), (0, 1), (1, 0), (0, 0), (2, 1), (1, 1), (1, 0), (2, 0)]
    held = []
    for s, j in order:
        held.append(((s, j), fwd(*inputs[s][j])))
        assert fwd.eager_reason is None
    torch.cuda.synchronize()
    for key, out in held:
        assert _same(out, eager[key]) == dict.fromkeys(out, True), key
