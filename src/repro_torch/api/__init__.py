"""Engine surface of the port (``BatonEngine``), the ``Deployment``
facade and its config sections, as ``repro.api`` exports them."""

from repro_torch.api.engine import (            # noqa: F401
    ENGINES, BatonEngine, Engine, ExactEngine, ExactIndex,
    ScatterGatherEngine, SearchResult, STAT_KEYS, get_engine,
)
from repro_torch.api.deployment import (        # noqa: F401
    Deployment, EXEC_FIELDS, MUTATE_FIELDS, REPORT_FIELDS, Report,
    SIM_FIELDS, partition_bytes,
)
from repro_torch.configs.batann_serve import (  # noqa: F401
    DataSpec, ExecSpec, IndexSpec, MutateSpec, SearchParams, ServeConfig,
    SimSpec,
)
