"""Model zoo SPI.

Reference: ``org.deeplearning4j.zoo.ZooModel``: ``conf()`` builds the
configuration and ``init()`` the network. Pretrained-weight loading lands
with a later slice.
"""

from __future__ import annotations


class ZooModel:
    """SPI base (reference ``org.deeplearning4j.zoo.ZooModel``)."""

    def init(self, device="cuda"):
        """Build the network with freshly initialized weights on ``device``."""
        raise NotImplementedError

    def conf(self):
        raise NotImplementedError
