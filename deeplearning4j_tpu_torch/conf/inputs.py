"""Input types and shape inference.

Reference: ``org.deeplearning4j.nn.conf.inputs.InputType`` (FF / RNN /
CNN / CNNFlat / CNN3D) — used by ``MultiLayerConfiguration`` `setInputType`
to infer nIn for every layer and auto-insert preprocessors.

The ``InputType.CNN`` carries (height, width, channels) semantics identical
to the reference. Arrays cross the port's public boundary in NHWC, as in the
JAX package; inside, tensors are logical NCHW in ``channels_last`` memory,
which is the same byte order, so the conversion is a free permute.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch import serde


@dataclasses.dataclass
class InputTypeBase:
    def arity(self) -> int:
        """Flattened per-example element count."""
        raise NotImplementedError


@serde.register
@dataclasses.dataclass
class FeedForward(InputTypeBase):
    size: int = 0

    def arity(self):
        return self.size


@serde.register
@dataclasses.dataclass
class Recurrent(InputTypeBase):
    size: int = 0
    timesteps: int = -1  # -1 = variable

    def arity(self):
        return self.size * max(self.timesteps, 1)


@serde.register
@dataclasses.dataclass
class Convolutional(InputTypeBase):
    height: int = 0
    width: int = 0
    channels: int = 0

    def arity(self):
        return self.height * self.width * self.channels


@serde.register
@dataclasses.dataclass
class ConvolutionalFlat(InputTypeBase):
    height: int = 0
    width: int = 0
    channels: int = 0

    def arity(self):
        return self.height * self.width * self.channels


@serde.register
@dataclasses.dataclass
class Convolutional3D(InputTypeBase):
    depth: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0

    def arity(self):
        return self.depth * self.height * self.width * self.channels


class InputType:
    """Factory namespace mirroring the reference's static methods."""

    @staticmethod
    def feed_forward(size: int) -> FeedForward:
        return FeedForward(size=size)

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> Recurrent:
        return Recurrent(size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> Convolutional:
        return Convolutional(height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> ConvolutionalFlat:
        return ConvolutionalFlat(height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_3d(depth: int, height: int, width: int,
                         channels: int) -> Convolutional3D:
        return Convolutional3D(depth=depth, height=height, width=width,
                               channels=channels)
