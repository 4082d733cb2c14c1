"""The SDK surface of the port: the YAML spec loader (``yaml_spec``)."""
