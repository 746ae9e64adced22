"""The shared layered configuration.

The port reads the reference's ``Config`` as it is (defaults < config.toml <
config.yaml < AMIRA_* env < legacy env); ``inference_backend`` follows the
device rule of ``device.py``.
"""

from amira_rust_asr_server_tpu.config import Config

__all__ = ["Config"]
