"""Gluon layers of the port."""

from .activations import ELU, GELU, LeakyReLU, PReLU, SELU, SiLU, Swish
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, RMSNorm,
                           Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          MaxPool1D, MaxPool2D, MaxPool3D, ReflectionPad2D)

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Dense", "Dropout", "ELU", "Embedding", "Flatten",
           "GELU", "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GroupNorm", "HybridLambda", "HybridSequential", "InstanceNorm",
           "Lambda", "LayerNorm", "LeakyReLU", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "PReLU", "RMSNorm", "ReflectionPad2D", "SELU",
           "Sequential", "SiLU", "Swish"]
