"""Shared constants (the port's copy of the JAX package's
common/constants.py): pod, job and task states, the strategy names and
the worker environment variables, the keep-alive interval and the
lease default.  The Local runner and a cluster job's master and workers
read them."""


class PodStatus:
    INITIAL = "Initial"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"
    UNKNOWN = "Unknown"


class PodType:
    MASTER = "master"
    WORKER = "worker"
    SERVING = "serving"


class JobStatus:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class TaskExecCounterKey:
    FAIL_COUNT = "fail_count"
    RECORDS = "records"


class DistributionStrategy:
    LOCAL = "Local"               # single process, in-process master
    ALLREDUCE = "AllReduce"       # elastic data parallelism
    PARAMETER_SERVER = "ParameterServer"  # accepted for CLI
    # compatibility; maps onto the data-parallel path.


class WorkerEnv:
    MASTER_ADDR = "ELASTICDL_MASTER_ADDR"
    WORKER_ID = "ELASTICDL_WORKER_ID"
    # The worker's own reachable address, injected via the k8s downward
    # API (pod IP).  Falls back to source-address discovery toward the
    # master when unset (common/net_utils.py).
    WORKER_ADDR = "ELASTICDL_WORKER_ADDR"


# Interval at which workers self-report liveness (+ their address) to the
# master over keep_alive; the master logs workers silent for several
# multiples of this.
KEEP_ALIVE_INTERVAL_S = 10.0


# Default lease duration before a "doing" task is considered abandoned and
# re-queued even without a pod-failure event (belt-and-braces on top of the
# k8s watch failure detector).
DEFAULT_TASK_LEASE_TIMEOUT_S = 15 * 60

GRPC_MAX_MESSAGE_LENGTH = 32 * 1024 * 1024
