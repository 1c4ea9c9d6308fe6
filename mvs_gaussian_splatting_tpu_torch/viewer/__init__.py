"""The network viewer: the SIBR remote-viewer wire protocol's server
(``network_gui``, pumped by the training loop) and a Python client."""

from . import network_gui  # noqa: F401
