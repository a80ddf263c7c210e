"""Applications built on the framework (port of round_tpu/apps): the config
ladder."""
