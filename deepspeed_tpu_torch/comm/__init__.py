"""deepspeed_tpu_torch.comm: collectives over torch.distributed (reference:
deepspeed/comm; JAX counterpart deepspeed_tpu/comm)."""

from .comm import (ReduceOp, all_gather, all_reduce, all_to_all,  # noqa: F401
                   barrier, broadcast, comm_device, destroy_process_group,
                   get_rank, get_world_size, host_all_gather_array,
                   host_all_reduce_scalar, init_distributed, is_initialized,
                   log_summary, new_group, reduce_scatter, timed_op)
from .comms_logging import (CommsLogger, calc_bw_log,  # noqa: F401
                            configure_comms_logger, get_comms_logger)

__all__ = ["ReduceOp", "all_gather", "all_reduce", "all_to_all", "barrier",
           "broadcast", "comm_device", "destroy_process_group", "get_rank",
           "get_world_size", "host_all_gather_array",
           "host_all_reduce_scalar", "init_distributed", "is_initialized",
           "log_summary", "new_group", "reduce_scatter", "timed_op",
           "CommsLogger", "calc_bw_log", "configure_comms_logger",
           "get_comms_logger"]
