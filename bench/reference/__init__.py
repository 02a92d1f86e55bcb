"""Plain PyTorch forwards of the benchmark's configurations, in float32 with
TF32 off: the reference that decides a run's ``correct``.

Each family module (``bloom``, ``chameleon``) reads the configuration's
published keys and the benchmark's own weight tree, and gives
``embed(w, c, tokens)``, ``layer(lw, c, h)`` and ``logits(w, c, h)``.
``common.run`` drives them layer by layer.  Nothing here imports the
program under test: it is given the benchmark's weights and tokens and
works everything else out again.
"""
