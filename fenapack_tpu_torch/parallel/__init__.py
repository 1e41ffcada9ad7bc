"""The multi-device paths on ``torch.distributed`` (gloo): ranks and
collectives (:mod:`.comm`); the ring path, with ring-halo products and
FGMRES (:mod:`.spmd`), distributed multigrid (:mod:`.spmd_gmg`) and the
distributed Oseen solve with its drivers (:mod:`.spmd_pcd`); the GSPMD
path, the single-device solver on row-sharded ranks (:mod:`.sharding`)."""
