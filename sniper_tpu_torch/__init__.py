"""sniper_tpu_torch — the SNIPER detector in PyTorch and CUDA for Hopper.

The port of ``sniper_tpu`` (JAX on a TPU), which stays beside it as the
reference: a ported piece is done when it gives the JAX output on the same
weights and inputs. This package imports torch and never jax; from
``sniper_tpu`` it uses only the (pure Python) config tree.

The slice ported so far is the flagship R101 detector's serving path
(``configs/sniper_res101_e2e.yml``): multi-scale inference through
``main_test.run_detection`` -> ``infer.tester.Tester`` -> ``aggregate``.

Package layout (the names of ``sniper_tpu``'s modules):
  config.py  the config tree (sniper_tpu.config)
  convert.py flax variables -> the port's state_dict
  ops/       boxes, anchors, NMS, proposals, deformable conv + ROI pool;
             ops/cuda.py builds and loads the CUDA kernels in csrc/
  models/    ResNet trunk, RPN / R-CNN heads, detector, registry, init
  data/      test-time batches (uint8 canvases per scale)
  infer/     the multi-scale Tester and its aggregation
  main_test  the inference CLI
"""

__version__ = "0.1.0"
