from repro_torch.hw.specs import (
    ALL_DEVICES,
    EDGE_DEVICES,
    TPU_V5E,
    DeviceSpec,
    get_device,
)

__all__ = [
    "ALL_DEVICES",
    "EDGE_DEVICES",
    "TPU_V5E",
    "DeviceSpec",
    "get_device",
]
