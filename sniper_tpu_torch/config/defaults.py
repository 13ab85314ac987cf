"""Configuration tree for sniper_tpu_torch: a copy of sniper_tpu/config/
defaults.py, so that the port loads configs/*.yml without that package.

Keeps the *key surface* of the reference config system
(the reference's ``configs/faster/default_configs.py:11-176`` plus the
yml-only keys the reference merges in silently at ``:191-192`` —
``TRAIN.NUM_PROCESS``, ``TEST.MAX_PER_IMAGE``, ``TEST.VALID_RANGES``,
``TEST.CONCURRENT_JOBS`` and friends) so that reference experiment YAMLs
load 1:1, while the implementation is a fresh, instance-based (not
global-mutable) attribute dict.

Differences from the reference by design:
- ``load_config`` returns a *new* config instance instead of mutating a
  module-level global; callers thread it explicitly.
- unknown nested keys are accepted under known sections (matching the
  reference's permissive nested merge) but unknown *top-level* keys
  raise, exactly like the reference (``default_configs.py:202-203``).
- TPU-relevant additions live under their own keys (``TRAIN.bf16``,
  ``parallel``) and never collide with reference keys.
"""

from __future__ import annotations

import copy
import re
from ast import literal_eval

import numpy as np
import yaml


class AttrDict(dict):
    """dict with attribute access; recursively wraps nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, AttrDict):
                self[k] = AttrDict(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        self[name] = value

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


# yml files in the reference use `!!python/tuple` tags; support them under
# safe_load so reference configs parse without arbitrary-code yaml.load.
class _RefYamlLoader(yaml.SafeLoader):
    pass


_RefYamlLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)),
)


def default_config() -> AttrDict:
    """Full default tree. Key names mirror the reference schema."""
    c = AttrDict()
    c.proposal_path = "data/proposals"
    c.MXNET_VERSION = ""  # accepted for yml compat; unused on TPU
    c.output_path = ""
    c.symbol = ""  # model name, e.g. 'resnet_mx_101_e2e'
    c.gpus = ""  # accepted for yml compat; device count comes from jax
    c.CLASS_AGNOSTIC = True
    c.default = AttrDict(kvstore="device")  # yml compat; unused on TPU

    # network
    n = c.network = AttrDict()
    n.pretrained = ""
    n.pretrained_epoch = 0
    n.PIXEL_MEANS = np.array([0.0, 0.0, 0.0])
    n.RPN_FEAT_STRIDE = 16
    n.FIXED_PARAMS = ["gamma", "beta"]
    n.ANCHOR_SCALES = (8, 16, 32)
    n.ANCHOR_RATIOS = (0.5, 1, 2)
    n.NUM_ANCHORS = 9
    # TPU-only knob (no reference analog): patch halo, in 7x7 bins, that
    # the fused deformable-ROI head's stencil pool can shift into;
    # per-bin offsets past it clamp (|trans| > margin/(trans_std*P) =
    # 1.43/margin_bin). 1 shrinks the patch 44->36 cells/axis (head
    # 25-35% faster); trained offsets measured 4.4x below the clamp
    # (scripts/profile_margin.py). Set 2 for the conservative halo.
    n.HEAD_MARGIN_BINS = 1
    # inference pool route of the 7x7 R-CNN head (models/registry.py:
    # _pool_kernel): "auto", "fused" and "einsum" run the fused pool
    # kernels (csrc/fused_pool.cu), "pallas" the patch route (the ROI
    # patch kernel csrc/roi_patch.cu, then torch ops; forward only, the
    # JAX package's per-roi parity oracle). Training always pools through
    # the fused kernels.
    n.POOL_KERNEL = "auto"
    # BatchNorm statistics mode for multi-device training: "sync"
    # (default — XLA computes statistics over the GLOBAL batch under
    # the auto-partitioned step, a quality superset) or "local"
    # (per-device statistics, the reference's training recipe:
    # the reference's README.md:10 trains per-GPU BN). Single-device
    # runs are identical either way; inference is always identical.
    n.BN_MODE = "sync"
    # ResNeXt grouped-3x3 formulation (models/resnext.py): number of
    # lane-aligned supergroups for the block-diagonal dense expansion.
    # 1 = full dense [f,f] expansion (64x grouped FLOPs, every tensor
    # T(8,128)-clean); SG>1 = feature_group_count=SG supergroups at
    # 64/SG x the FLOPs. v5e A/B (scripts/profile_supergroups.py):
    # SG=4 is 12-20% faster at <=832x1088 canvases and the train
    # shape but 10% SLOWER at 1408x1920, which dominates the
    # multi-scale pyramid — so the default stays 1; set 4 for
    # training or small-canvas serving.
    n.RESNEXT_SUPERGROUPS = 1

    # dataset
    d = c.dataset = AttrDict()
    d.dataset = "PascalVOC"
    d.image_set = "2007_trainval"
    d.test_image_set = "2007_test"
    d.root_path = "./data"
    d.dataset_path = "./data/VOCdevkit"
    d.NUM_CLASSES = 21
    d.proposal = "rpn"

    # TRAIN
    t = c.TRAIN = AttrDict()
    t.ONLY_PROPOSAL = False
    t.CPP_CHIPS = False
    t.USE_NEG_CHIPS = True
    t.CHIPS_DB_PARTS = 20
    t.WITH_MASK = False
    t.AUTO_FOCUS = False
    t.AUTO_FOCUS_SMALL_THRESH = -1
    t.AUTO_FOCUS_DC_LOW = -1
    t.AUTO_FOCUS_DC_HIGH = -1
    # >1 -> the per-epoch chip re-roll maps over a spawn-based
    # multiprocessing.Pool (the reference's Pool(NUM_PROCESS=64),
    # MNIteratorE2E.py:47-53) — opt in on multi-core hosts at dataset
    # scale; 0/1 keeps the in-process path (NUM_THREAD threads).
    # Results are bit-identical either way (per-image seeds).
    t.NUM_PROCESS = 0
    t.NUM_THREAD = 8
    # run batch ASSEMBLY (the whole ChipLoader) in a spawned child
    # process over shared memory, leaving this interpreter only relay
    # framing + step dispatch (data/shm_loader.py). Bit-parity tested
    # (tests/test_shm_loader.py); A/B'd on this box by
    # scripts/profile_pipeline_process.py.
    t.LOADER_PROCESS = False
    t.lr = 0.0
    t.VALID_RANGES = ((-1, 80), (32, 150), (120, -1))
    t.SCALES = (3.0, 1.667, 512.0)
    t.lr_step = ""
    t.scale = 1.0  # reference fp16 loss scale; no-op under bf16
    t.lr_factor = 0.1
    t.warmup = False
    t.warmup_lr = 0.0
    t.warmup_step = 0
    t.momentum = 0.9
    t.wd = 0.0005
    t.fp16 = False  # reference flag; maps to bf16 trunk on TPU
    t.bf16 = True  # TPU-native: bf16 trunk compute, fp32 master params
    t.begin_epoch = 0
    t.end_epoch = 0
    t.model_prefix = ""
    t.FLIP = True
    t.SHUFFLE = True
    t.ENABLE_OHEM = False
    t.BATCH_IMAGES = 2  # per-device
    t.END2END = False
    t.BATCH_ROIS = 128
    t.BATCH_ROIS_OHEM = 128
    t.FG_FRACTION = 0.25
    t.FG_THRESH = 0.5
    t.BG_THRESH_HI = 0.5
    t.BG_THRESH_LO = 0.0
    t.BBOX_REGRESSION_THRESH = 0.5
    t.BBOX_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.0])
    t.visualization_path = "debug/visualization"
    t.visualization_freq = 100
    # opt-in switch for training-chip debug rendering (the reference's
    # MNIteratorE2E.visualize is permanently commented out at its call
    # site, MNIteratorE2E.py:218; here TRAIN.VISUALIZE=True renders
    # every visualization_freq-th chip + its gt boxes to
    # visualization_path — sniper_tpu addition)
    t.VISUALIZE = False
    t.RPN_BATCH_SIZE = 256
    t.RPN_FG_FRACTION = 0.5
    t.RPN_POSITIVE_OVERLAP = 0.7
    t.RPN_NEGATIVE_OVERLAP = 0.3
    t.RPN_CLOBBER_POSITIVES = False
    t.RPN_BBOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    t.RPN_POSITIVE_WEIGHT = -1.0
    t.CXX_PROPOSAL = True
    t.RPN_NMS_THRESH = 0.7
    t.RPN_PRE_NMS_TOP_N = 12000
    t.RPN_POST_NMS_TOP_N = 2000
    t.RPN_MIN_SIZE = 16
    t.BBOX_NORMALIZATION_PRECOMPUTED = False
    t.BBOX_MEANS = (0.0, 0.0, 0.0, 0.0)
    t.BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
    t.ALTERNATE = AttrDict(  # legacy alternate-training keys (yml compat)
        RPN_BATCH_IMAGES=0, RCNN_BATCH_IMAGES=0,
        rpn1_lr=0, rpn1_lr_step="", rpn1_epoch=0,
        rfcn1_lr=0, rfcn1_lr_step="", rfcn1_epoch=0,
        rpn2_lr=0, rpn2_lr_step="", rpn2_epoch=0,
        rfcn2_lr=0, rfcn2_lr_step="", rfcn2_epoch=0,
        rpn3_lr=0, rpn3_lr_step="", rpn3_epoch=0,
    )
    # sniper_tpu additions (not in reference):
    t.CHIP_SIZE = 512
    t.CHIP_STRIDE_RANGE = (56, 60)  # re-rolled each epoch
    t.MAX_GT_BOXES = 100  # padded gt_boxes[100, 5]
    t.MAX_POLY_LEN = 500  # padded encoded polygons per gt
    t.seed = 0

    # TEST
    s = c.TEST = AttrDict()
    s.NMS_SIGMA = 0.6
    s.TEST_FLAG = False
    s.HAS_RPN = False
    s.BATCH_IMAGES = 1
    s.CXX_PROPOSAL = True
    s.RPN_NMS_THRESH = 0.7
    s.RPN_PRE_NMS_TOP_N = 6000
    s.RPN_POST_NMS_TOP_N = 300
    s.RPN_MIN_SIZE = 16
    s.PROPOSAL_NMS_THRESH = 0.7
    s.PROPOSAL_PRE_NMS_TOP_N = 20000
    s.PROPOSAL_POST_NMS_TOP_N = 2000
    s.PROPOSAL_MIN_SIZE = 16
    s.AUTO_FOCUS = False
    s.DO_PRUNING = [False, False, False]
    s.CHIP_HYPERPARAMS = [(-1, -1, -1), (-1, -1, -1), (-1, -1, -1)]
    s.USE_CACHE = [False, False, False]
    s.NMS = 0.3
    s.max_per_image = 300
    s.test_epoch = 0
    # yml-only keys that are part of the real schema:
    s.MAX_PER_IMAGE = 200
    s.SCALES = ((1400, 2000), (800, 1280), (480, 512))
    s.CONCURRENT_JOBS = 1
    s.VALID_RANGES = ((-1, 90), (32, 180), (75, -1))
    s.TEST_EPOCH = 7
    s.VISUALIZATION_PATH = "./debug/visualization"
    s.VISUALIZE_INTERMEDIATE_SCALES = False
    s.EXTRACT_PROPOSALS = False
    s.PROPOSAL_SAVE_PATH = "output/proposals"
    s.N_PROPOSAL_PER_SCALE = 300
    s.AGGREGATION_NMS_PRE_MAX = 1000  # sniper_tpu addition

    # parallel (sniper_tpu addition): TPU mesh layout
    p = c.parallel = AttrDict()
    p.data_axis = "data"
    p.num_devices = -1  # -1 → all visible devices
    p.sync_batchnorm = False  # reference trains per-device BN stats
    # multi-host DP (parallel/distributed.py); env fallbacks
    # SNIPER_COORDINATOR / SNIPER_NUM_PROCESSES / SNIPER_PROCESS_ID
    p.coordinator_address = ""  # "host:port" of process 0
    p.num_processes = 0         # 0/1 → single-process (no-op)
    p.process_id = -1           # this process's rank

    return c


def update_config(cfg: AttrDict, config_file: str) -> AttrDict:
    """Merge a YAML experiment file into ``cfg`` (in place; returns cfg).

    Mirrors reference ``update_config`` semantics
    (``default_configs.py:178-203``): top-level keys must already exist;
    nested keys under known sections may be new (the yml is the schema);
    PIXEL_MEANS / BBOX_WEIGHTS are coerced to np arrays.
    """
    with open(config_file) as f:
        exp = yaml.load(f, Loader=_RefYamlLoader)
    for k, v in exp.items():
        if k not in cfg:
            raise KeyError(f"unknown top-level config key: {k!r}")
        if isinstance(v, dict):
            if k == "TRAIN" and "BBOX_WEIGHTS" in v:
                v["BBOX_WEIGHTS"] = np.array(v["BBOX_WEIGHTS"], dtype=np.float64)
            if k == "network" and "PIXEL_MEANS" in v:
                v["PIXEL_MEANS"] = np.array(v["PIXEL_MEANS"], dtype=np.float64)
            for vk, vv in v.items():
                cfg[k][vk] = AttrDict(vv) if isinstance(vv, dict) else vv
        else:
            cfg[k] = v
    return cfg


def update_config_from_list(cfg: AttrDict, cfg_list) -> AttrDict:
    """CLI ``--set a.b.c value`` overrides (reference ``:205-226``)."""
    assert len(cfg_list) % 2 == 0, "--set expects key value pairs"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        d = cfg
        *path, leaf = k.split(".")
        for sub in path:
            assert sub in d, f"unknown config key: {k!r}"
            d = d[sub]
        assert leaf in d, f"unknown config key: {k!r}"
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        old = d[leaf]
        if old is not None and not isinstance(old, (str,)) and isinstance(value, str):
            raise TypeError(f"type mismatch for {k}: {type(value)} vs {type(old)}")
        d[leaf] = value
    return cfg


def load_config(config_file: str | None = None, overrides=()) -> AttrDict:
    """defaults → yaml → CLI overrides, as a fresh instance."""
    cfg = default_config()
    if config_file:
        update_config(cfg, config_file)
    if overrides:
        update_config_from_list(cfg, list(overrides))
    return cfg


def config_name(config_file: str) -> str:
    """Experiment identity = config filename (reference utils.py:126-134)."""
    return re.sub(r"\.ya?ml$", "", config_file.split("/")[-1])
