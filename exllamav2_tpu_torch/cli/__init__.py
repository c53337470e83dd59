"""The reference's command-line tools as twins inside the port.

Each module is started as ``python -m exllamav2_tpu_torch.cli.<name>`` and
has a ``main(argv=None)`` that takes an argument list, so that it can also be
called in process. Every tool that runs a model runs it on the card unless
``--device cpu`` is given.
"""
