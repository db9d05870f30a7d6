"""Device ops: the selective scans (kernels + plain versions), cross-scan,
causal conv1d and the decode state update.

Importing this package registers the scan kernels' custom ops
(``torch.ops.mamba_unet.*``), which a saved ``torch.export`` program of the
port calls: import it before loading one."""

from mamba_unet_torch.ops import (  # noqa: F401  (registers the custom ops)
    selective_scan_bidir,
    selective_scan_folded,
    selective_scan_grouped,
)
