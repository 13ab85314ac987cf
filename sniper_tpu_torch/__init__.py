"""sniper_tpu_torch — the SNIPER detector in PyTorch and CUDA for Hopper.

The port of ``sniper_tpu`` (JAX on a TPU), which stays beside it as the
reference: a ported piece is done when it gives the JAX output on the same
weights and inputs. This package imports torch and never jax, and nothing
of ``sniper_tpu``: it keeps its own copies of the host modules it needs
(the config tree, the dataset readers, the COCO evaluator, mask pasting).

The slices ported so far, for the flagship R101 detector
(``configs/sniper_res101_e2e.yml``): multi-scale inference
(``main_test.run_detection`` -> ``infer.tester.Tester`` -> ``aggregate``)
and SNIPER training (``main_train.run_training``), with the mask branch
(``configs/sniper_res101_e2e_mask.yml``) and AutoFocus
(``configs/sniper_res101_e2e_autofocus.yml``); and the rest of the model
zoo, ResNeXt-101 (the registry symbol ``resnext_mx_101``) and MobileNetV2
(``configs/sniper_mobilenetv2_e2e.yml``), inference and training; data
parallelism over several cards for both (``parallel.num_devices``); and
the last options: OHEM, mask and AutoFocus training together,
TRAIN.VISUALIZE's renderings and prediction dumps, the single-image demo,
the profiler and the Tester's per-chip NMS.

Package layout (the names of ``sniper_tpu``'s modules):
  config/       the config tree (a copy of sniper_tpu/config)
  convert.py    flax variables -> the port's state_dict
  ops/          boxes, anchors, NMS, proposals and the training sampler,
                OHEM, deformable conv + ROI pool with their backward
                passes, the patch route of the pool (the mask branch's);
                ops/cuda.py builds and loads the CUDA kernels in csrc/
  models/       ResNet, ResNeXt and MobileNetV2 trunks, BatchNorm, RPN /
                R-CNN / mask / FocusPixel heads, detector, losses,
                registry, init
  chips/        SNIPER chip generation and box assignment
  data/         the training chip loader, anchor targets, roidb building,
                test-time batches, the COCO / VOC readers and evaluators
  train/        the train step, optimizer, metrics, checkpoints, the
                training prediction dumps
  infer/        the multi-scale Tester and its aggregation, mask pasting
                and RLE encoding
  parallel/     data parallelism: the process group (NCCL, gloo), DDP,
                inference replicas
  utils/        rendering (cv2), the profiler, the logger
  main_train    the training CLI
  main_test     the inference CLI
  demo          the single-image demo CLI
"""

__version__ = "0.1.0"
