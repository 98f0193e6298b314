"""Device probing utilities.

Equivalent of the reference's `CudaDevice` probe
(src/lib/common/common.cu:13-22), built on `jax.devices()`.
"""

from __future__ import annotations

from .errors import NTTDeviceError


def available_devices(platform: str | None = None):
    """Enumerate accelerator devices visible to JAX.

    Reference parity: CudaDevice() (common.cu:13-22) prints and returns
    the active GPU; we return the full device list so multi-device callers
    can build a mesh out of it.
    """
    import jax

    try:
        if platform is None:
            return jax.devices()
        return jax.devices(platform)
    except RuntimeError as e:  # no backend of that platform
        raise NTTDeviceError(str(e)) from e


def default_device():
    """First visible device (the reference always used device 0)."""
    devs = available_devices()
    if not devs:
        raise NTTDeviceError("No JAX devices found")
    return devs[0]


def device_summary() -> str:
    """Human-readable device table (the reference printed GPU name/SM count)."""
    import jax

    lines = []
    for d in jax.devices():
        lines.append(
            f"id={d.id} platform={d.platform} kind={getattr(d, 'device_kind', '?')}"
            f" process={d.process_index}"
        )
    return "\n".join(lines)
