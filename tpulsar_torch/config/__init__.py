"""Typed, validated configuration — counterpart of tpulsar/config/
(reference: lib/python/config/): the same domains as dataclasses,
loaded from one python or YAML file (TPULSAR_CONFIG), with a
consolidated InsaneConfigsError."""

from tpulsar_torch.config.core import (  # noqa: F401
    ConfigError,
    InsaneConfigsError,
    TpulsarConfig,
    load_config,
    settings,
    set_settings,
)
