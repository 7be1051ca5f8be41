from .schema import Config, ConfigError, load_config

__all__ = ["Config", "ConfigError", "load_config"]
