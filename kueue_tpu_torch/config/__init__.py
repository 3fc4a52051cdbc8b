"""Controller configuration (reference apis/config/v1beta1 + pkg/config)."""

from .configuration import (
    Configuration,
    ConfigValidationError,
    FairSharingConfig,
    IntegrationsConfig,
    MultiKueueConfigOptions,
    RequeuingStrategy,
    ResourceTransformation,
    ResourcesConfig,
    WaitForPodsReady,
    default_configuration,
    load,
    validate,
)

__all__ = [
    "Configuration", "ConfigValidationError", "FairSharingConfig",
    "IntegrationsConfig", "MultiKueueConfigOptions", "RequeuingStrategy",
    "ResourceTransformation", "ResourcesConfig", "WaitForPodsReady",
    "default_configuration", "load", "validate",
]
