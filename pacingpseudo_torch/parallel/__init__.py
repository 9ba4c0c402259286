"""Training over several devices: the data-parallel rank group (``mesh``)."""
from pacingpseudo_torch.parallel.mesh import (RankGroup, attach_ranks, backend_for,
                                              close_rank_group, factor_devices,
                                              init_rank_group, make_resident_gather,
                                              plan_data_parallel, replicate, spawn_ranks,
                                              stage_resident_pool, sum_over_ranks)

__all__ = ["RankGroup", "attach_ranks", "backend_for", "close_rank_group", "factor_devices",
           "init_rank_group", "make_resident_gather", "plan_data_parallel", "replicate",
           "spawn_ranks", "stage_resident_pool", "sum_over_ranks"]
