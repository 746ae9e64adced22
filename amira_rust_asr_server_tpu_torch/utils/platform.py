"""Platform detection and startup orchestration (port of
``utils/platform.py``).

Probes the host OS, the accelerator topology and the cloud environment,
derives the effective settings and validates them at startup, with the
reference's names. What differs:

- ``detect_devices`` reads torch: the CUDA devices (name, memory, SM count),
  or one CPU device when CUDA is absent.
- ``detect_cloud`` keeps the reference's environment checks and its one
  short metadata attempt; with no network the provider is ``"unknown"``.
- ``initialize_platform`` keeps the mesh adjustment and ``validate()`` but
  not the reference's "no TPU visible -> ``inference_backend="cpu"``"
  rewrite: that fallback would hide a missing device. The port's device
  rule (``device.resolve_device``) raises ``DeviceError`` instead.
"""

from __future__ import annotations

import dataclasses
import os
import platform as _platform
from typing import Any, List, Optional

import torch

from ..config import Config
from ..reliability import get_logger

log = get_logger("asr.platform")

@dataclasses.dataclass
class HostInfo:
    """Host OS/arch probe (ref: platform/detection.rs:9-110)."""

    os: str
    kernel: str
    arch: str
    cpu_count: int
    memory_gb: float
    in_container: bool


@dataclasses.dataclass
class DeviceTopology:
    """Accelerator topology: the CUDA devices torch sees, or the CPU."""

    platform: str               # cuda | cpu
    n_devices: int
    device_kinds: List[str]
    n_processes: int
    process_index: int
    coords: Optional[List[Any]]  # chip coordinates: none on CUDA
    memory_per_device_gb: Optional[float]
    sm_count: Optional[int] = None  # streaming multiprocessors per device


@dataclasses.dataclass
class CloudInfo:
    """Cloud environment (ref: platform/cloud_detection.rs:15-522)."""

    provider: str               # gcp | aws | azure | none/unknown
    instance_type: Optional[str] = None
    zone: Optional[str] = None
    tpu_env: bool = False


@dataclasses.dataclass
class PlatformInit:
    host: HostInfo
    devices: DeviceTopology
    cloud: CloudInfo
    effective_config: Config


def detect_host() -> HostInfo:
    mem_gb = 0.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    mem_gb = int(line.split()[1]) / 1024 / 1024
                    break
    except OSError:
        pass
    return HostInfo(
        os=_platform.system().lower(),
        kernel=_platform.release(),
        arch=_platform.machine(),
        cpu_count=os.cpu_count() or 1,
        memory_gb=round(mem_gb, 1),
        in_container=os.path.exists("/.dockerenv"),
    )


def detect_devices() -> DeviceTopology:
    """The CUDA devices (count, names, memory, SM count of device 0), or one
    CPU device when CUDA is absent."""
    if not torch.cuda.is_available():
        return DeviceTopology(platform="cpu", n_devices=1,
                              device_kinds=[_platform.machine() or "cpu"],
                              n_processes=1, process_index=0, coords=None,
                              memory_per_device_gb=None)
    n = torch.cuda.device_count()
    props = [torch.cuda.get_device_properties(i) for i in range(n)]
    return DeviceTopology(
        platform="cuda", n_devices=n,
        device_kinds=sorted({p.name for p in props}),
        n_processes=1, process_index=0, coords=None,
        memory_per_device_gb=round(props[0].total_memory / 1024 ** 3, 1),
        sm_count=props[0].multi_processor_count)


def detect_cloud(timeout_s: float = 0.3) -> CloudInfo:
    """Environment variables first (TPU VMs export them), then one short
    metadata attempt; with no network the provider is ``"unknown"``."""
    if os.environ.get("TPU_WORKER_HOSTNAMES") or \
            os.environ.get("TPU_SKIP_MDS_QUERY"):
        return CloudInfo(provider="gcp", tpu_env=True)
    try:
        import urllib.request
        req = urllib.request.Request(
            "http://metadata.google.internal/computeMetadata/v1/instance/"
            "machine-type", headers={"Metadata-Flavor": "Google"})
        body = urllib.request.urlopen(req, timeout=timeout_s).read().decode()
        return CloudInfo(provider="gcp", instance_type=body.rsplit("/", 1)[-1])
    except Exception:  # noqa: BLE001 — zero-egress or non-GCP
        return CloudInfo(provider="unknown")


def initialize_platform(config: Optional[Config] = None) -> PlatformInit:
    """Startup orchestration (ref: platform/init.rs:28-536): probe, adjust
    the mesh, validate, log one structured summary."""
    cfg = config or Config()
    host = detect_host()
    devices = detect_devices()
    cloud = detect_cloud()
    if not cfg.mesh_shape and devices.n_devices > 1:
        cfg = dataclasses.replace(
            cfg, mesh_shape={"data": devices.n_devices, "model": 1})
    cfg.validate()
    log.info("platform initialized", extra={"fields": {
        "host": dataclasses.asdict(host),
        "devices": {k: v for k, v in dataclasses.asdict(devices).items()
                    if k != "coords"},
        "cloud": dataclasses.asdict(cloud),
    }})
    return PlatformInit(host=host, devices=devices, cloud=cloud,
                        effective_config=cfg)
