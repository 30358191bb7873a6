"""repro_torch.nn — torch.nn-shaped neural network API (counterpart of
``repro.nn``), the recurrent layers (``nn/rnn.py``: LSTM, LSTMCell)
included."""

from . import functional
from .layers import (
    GELU,
    SiLU,
    AdaptiveAvgPool2d,
    AvgPool2d,
    BatchNorm2d,
    Conv1d,
    Conv2d,
    Dropout,
    Embedding,
    Flatten,
    Hardswish,
    Identity,
    LayerNorm,
    Linear,
    MaxPool2d,
    ReLU,
    ReLU6,
    RMSNorm,
    Sigmoid,
    Softmax,
    Tanh,
)
from .module import (
    Module,
    ModuleDict,
    ModuleList,
    Parameter,
    Sequential,
    functional_call,
    param_dict,
)
from .rnn import LSTM, LSTMCell
