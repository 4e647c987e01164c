"""PyTorch/CUDA port of ``eyediseasesegmentation_tpu``.

The module layout mirrors the JAX package, so each file here has a counterpart
of the same path there. Only inference is ported so far: the whole-image
pipeline over the flagship ``UnetPlusPlusStar`` (checkpoint loading from a run
directory, the x8-TTA predictor, on-device metrics, ``test_tta`` and
``evaluate``), with the JAX package's four Pallas kernels written in CUDA for
Hopper (``csrc/``). ROADMAP.md lists what is still to be ported.

Importing this package imports torch and numpy only; kernels are compiled on
first use, and PIL, cv2 and matplotlib are imported where a file is read or
written.
"""
