"""Model layer: blocks, bridges, encoder / ROI decoder and ``MaskTransUnet``."""

from lintransunet_tpu_torch.models.blocks import (
    ConvPosEmbed3d,
    DownBlock,
    DownEmbedBlock,
    EmbedAttention3DBlock,
    MultiheadLinearAttention,
    PosAttention3DBlock,
    SelfAttentionLayer,
    SpatialAttentionGate,
    UpBlock,
    UpEmbedBlock,
    lecun_normal_,
)
from lintransunet_tpu_torch.models.bridges import ConnectBridge, InitialBridge, ROIBridge
from lintransunet_tpu_torch.models.registry import MaskTransUnet, init_random_, one_hot_argmax
from lintransunet_tpu_torch.models.unet import Encoder, ROIDecoder, decoder_scale, encoder_stride

__all__ = [
    "ConvPosEmbed3d",
    "DownBlock",
    "DownEmbedBlock",
    "EmbedAttention3DBlock",
    "MultiheadLinearAttention",
    "PosAttention3DBlock",
    "SelfAttentionLayer",
    "SpatialAttentionGate",
    "UpBlock",
    "UpEmbedBlock",
    "lecun_normal_",
    "ConnectBridge",
    "InitialBridge",
    "ROIBridge",
    "MaskTransUnet",
    "init_random_",
    "one_hot_argmax",
    "Encoder",
    "ROIDecoder",
    "decoder_scale",
    "encoder_stride",
]
