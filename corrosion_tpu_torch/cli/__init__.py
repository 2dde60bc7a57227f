"""The port's command line (`main`): the ``sim`` command of
``corrosion_tpu/cli/main.py`` for the scenarios, campaigns and views the
port carries.  Run as ``python -m corrosion_tpu_torch.cli.main sim ...``."""
