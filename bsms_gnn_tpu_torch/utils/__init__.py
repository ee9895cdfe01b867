"""Console metrics, timing, profiling and plots of the CLIs (counterpart
of `bsms_gnn_tpu/utils/`; XLA's compile cache, `utils/cache.py` there, has
no counterpart: the port's kernels are cached by `ops/kernels/build.py`)."""

from bsms_gnn_tpu_torch.utils.logging import (  # noqa: F401
    MetricLogger,
    board_loss,
    print_error_table,
)
from bsms_gnn_tpu_torch.utils.profiling import (  # noqa: F401
    device_trace,
    throughput,
)
from bsms_gnn_tpu_torch.utils.timing import (  # noqa: F401
    TicToc,
    simple_timeit,
    timeit,
)
