"""Launchers and step pricing: ``costs`` (the roofline of a pooled step on
one H100 and the τ calibration arithmetic), ``serve`` (the serving
launcher, ``python -m repro_torch.launch.serve``) and ``train`` (the
training launcher, ``python -m repro_torch.launch.train``)."""
