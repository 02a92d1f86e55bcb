"""Launchers, step pricing and device groups: ``costs`` (the roofline of a
pooled step on one H100, its collectives over NVLink, the τ calibration
arithmetic, and ``StepCount``: a step's count on meta tensors), ``mesh``
(``GroupMesh``, ``group_meshes``, ``make_production_mesh``), ``sharding``
(the reference's layout rules of a device group), ``dryrun`` (every
(arch x shape x production mesh) cell counted per slot on meta tensors,
``python -m repro_torch.launch.dryrun``), ``report`` (its tables),
``serve`` (the serving launcher, ``python -m repro_torch.launch.serve``)
and ``train`` (the training launcher, ``python -m
repro_torch.launch.train``)."""
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh

__all__ = ["make_mesh_for", "make_production_mesh"]
