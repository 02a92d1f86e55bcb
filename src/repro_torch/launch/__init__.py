"""Launchers, step pricing and device groups: ``costs`` (the roofline of a
pooled step on one H100, its collectives over NVLink, and the τ
calibration arithmetic), ``mesh`` (``GroupMesh``, ``group_meshes``),
``sharding`` (the serving rules of a device-group server), ``serve`` (the
serving launcher, ``python -m repro_torch.launch.serve``) and ``train``
(the training launcher, ``python -m repro_torch.launch.train``)."""
