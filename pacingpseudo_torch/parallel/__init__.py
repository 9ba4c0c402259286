"""Training over several devices: the rank group on a data x space grid
(``mesh``) and height sharding (``spatial``)."""
from pacingpseudo_torch.parallel.mesh import (RankGroup, attach_ranks, backend_for,
                                              close_rank_group, factor_devices,
                                              init_rank_group, make_grid,
                                              make_resident_gather, plan_data_parallel,
                                              replicate, resolve_devices, spawn_ranks,
                                              stage_resident_pool, sum_over_ranks)

__all__ = ["RankGroup", "attach_ranks", "backend_for", "close_rank_group", "factor_devices",
           "init_rank_group", "make_grid", "make_resident_gather", "plan_data_parallel",
           "replicate", "resolve_devices", "spawn_ranks", "stage_resident_pool",
           "sum_over_ranks"]
