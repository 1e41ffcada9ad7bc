"""The multi-device ring path on ``torch.distributed`` (gloo): ranks and
collectives (:mod:`.comm`), ring-halo products and FGMRES (:mod:`.spmd`),
distributed multigrid (:mod:`.spmd_gmg`) and the distributed Oseen solve
with its drivers (:mod:`.spmd_pcd`)."""
