"""Launchers -- counterpart of `repro.launch`: meshes (`mesh`), the
training and serving entry points (`train`, `serve`: ``python -m
repro_torch.launch.train`` / ``.serve``), the dry run over the
production meshes (`dryrun`) and the `hlo_analysis` shim.  Importing a
module here touches no device and starts no process."""
