"""ParamAttr (counterpart of paddle_tpu/param_attr.py): a parameter's
name, initializer, learning-rate multiplier, regularizer, trainability
and whether gradient clipping applies to it. `nn.Layer.create_parameter`
reads it."""

from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """Normalise user input: None | False | str | initializer |
        ParamAttr."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        # an initializer instance
        return ParamAttr(initializer=attr)
