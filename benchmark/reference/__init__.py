"""The plain reference that decides ``correct``.

``frozen/`` is a frozen copy of the port's plain PyTorch path (the dense
engine's solver and binning, the gather engine's step and hash grid, the
render, and each kernel's plain version in place of the kernel), taken at
commit e9e0aedb87f3 and left unchanged but for its kernel routes and the
solver's hand-over of a gather step to ``gather_step.py``; it imports
nothing of the port. ``batched`` computes kernel B's plain pair sums a
chunk of partner offsets at a time, bit for bit the frozen loop's, and
takes its place. ``spawn`` builds a scene's first state from the
configuration, ``model`` steps and renders from a state, ``control`` runs
the same in a lower precision or as the witness. Nothing here imports
``jax``, the JAX package or the port.
"""
