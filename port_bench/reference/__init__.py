"""The benchmark's plain reference: plain PyTorch and NumPy, written from
the published models and training recipes, importing nothing of the
program under test.

* ``precision`` - the matrix products of the reference in float32 (TF32
  off) or, for the control, with their operands rounded to float8 e4m3;
* ``scan`` - the bidirectional selective scan as a sequential fp32 loop;
* ``net`` - Mamba-UNet's building blocks as functions of a dict of
  tensors, and the seeded initial weights; a model family is
  ``<reference>.py`` (here ``vssm``: ``ViM_seg``), found by the
  configuration's ``reference`` key;
* ``data`` - the training transform and the batch sampler, worked out
  again from the raw slices;
* ``train`` - the losses' parts and SGD, followed for the first steps of
  a run; a training method is ``<method>.py`` (here ``supervised``),
  found by the traffic's ``method`` key.
"""
