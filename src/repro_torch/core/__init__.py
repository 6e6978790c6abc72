"""Core: the paper's contribution — flexible 2..8-bit precision scaling via
efficient weight combination (Table-I decomposition, bit-serial MAC, CSA
tree, PE-array functional model, mixed-precision policy).  Port of
``repro.core``; the same exports."""
from repro_torch.core.decompose import (  # noqa: F401
    DECOMP_SCHEDULE,
    RUNTIME_W_BITS,
    SUPERPLANE_BITS,
    SUPPORTED_BITS,
    decompose_superplanes,
    decompose_weights,
    decomposed_matmul,
    num_planes,
    num_prefix_planes,
    plane_shifts,
    prefix_shifts,
    recompose_weights,
    weight_range,
)
from repro_torch.core.quant import (  # noqa: F401
    MAX_BITS,
    QuantConfig,
    compute_scale,
    fake_quant,
    nested_quantize,
    nested_scale,
    quantize,
    truncate_qint,
)
from repro_torch.core.bitserial import (  # noqa: F401
    activation_bitplanes,
    bitserial_mac,
)
from repro_torch.core.adder_tree import (  # noqa: F401
    csa_tree_sum,
    msb_path_activity,
)
from repro_torch.core.pe_array import (  # noqa: F401
    PEArrayConfig,
    PEArrayStats,
    array_utilization,
    pe_array_matmul,
    peak_tops,
)
from repro_torch.core.policy import (  # noqa: F401
    BACKENDS,
    LayerPrecision,
    PrecisionPolicy,
    PrecisionSchedule,
    allocate_bits_by_sensitivity,
    uniform_policy,
    uniform_schedule,
)
