"""DNN layer descriptors and the paper's workload suite.

The paper (Sec 6.1) evaluates on MnasNet plus AlexNet, ResNet50, MobileNetV2
(vision), BERT (language) and DLRM/NCF (recommendation).  Every layer is
normalized to the 6-dim CONV loop nest (K, C, Y, X, R, S):

  K : output channels        C : input channels
  Y : output height          X : output width
  R : filter height          S : filter width

GEMM (M, N, Kg) maps to (K=M, C=Kg, Y=N, X=1, R=1, S=1), matching the paper's
Sec 7 observation that BERT's (M,N,K) land on (K_conv, C, Y).  Depthwise conv
is expressed with K=1 per the paper's Layer-29 example "(1, 480, 14, 14, 5, 5)".
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

DIMS = ("K", "C", "Y", "X", "R", "S")
NUM_DIMS = len(DIMS)
K, C, Y, X, R, S = range(NUM_DIMS)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One DNN layer as a 6-dim loop nest (paper Fig 1)."""

    name: str
    dims: Tuple[int, int, int, int, int, int]  # (K, C, Y, X, R, S)
    stride: int = 1
    depthwise: bool = False

    @property
    def macs(self) -> int:
        k, c, y, x, r, s = self.dims
        if self.depthwise:
            # K==1 in the paper's notation: one output channel per input channel.
            return c * y * x * r * s
        return k * c * y * x * r * s

    def dim(self, i: int) -> int:
        return self.dims[i]

    def as_array(self) -> np.ndarray:
        return np.asarray(self.dims, dtype=np.int64)


def conv(name: str, k: int, c: int, y: int, x: int, r: int, s: int,
         stride: int = 1) -> Layer:
    return Layer(name, (k, c, y, x, r, s), stride=stride)


def dwconv(name: str, c: int, y: int, x: int, r: int, s: int,
           stride: int = 1) -> Layer:
    # Depthwise conv: no cross-channel reduction; K=1 per paper notation.
    return Layer(name, (1, c, y, x, r, s), stride=stride, depthwise=True)


def gemm(name: str, m: int, n: int, kg: int) -> Layer:
    """GEMM (M,N,K) -> CONV (K=M, C=Kg, Y=N, X=1, R=1, S=1)."""
    return Layer(name, (m, kg, n, 1, 1, 1))


# --------------------------------------------------------------------------
# Model zoos (layer dims from the original papers / torchvision definitions)
# --------------------------------------------------------------------------

def alexnet() -> List[Layer]:
    """AlexNet [Krizhevsky et al. 2012] — 5 CONV + 3 FC."""
    return [
        conv("conv1", 96, 3, 55, 55, 11, 11, stride=4),
        conv("conv2", 256, 96, 27, 27, 5, 5),
        conv("conv3", 384, 256, 13, 13, 3, 3),
        conv("conv4", 384, 384, 13, 13, 3, 3),
        conv("conv5", 256, 384, 13, 13, 3, 3),
        gemm("fc6", 4096, 1, 9216),
        gemm("fc7", 4096, 1, 4096),
        gemm("fc8", 1000, 1, 4096),
    ]


def _resnet_bottleneck(layers: List[Layer], stage: str, n_blocks: int,
                       c_in: int, c_mid: int, yx: int, first_stride: int) -> int:
    c_out = c_mid * 4
    for b in range(n_blocks):
        stride = first_stride if b == 0 else 1
        cin = c_in if b == 0 else c_out
        y = yx
        layers.append(conv(f"{stage}.{b}.conv1", c_mid, cin, y, y, 1, 1, stride=1))
        layers.append(conv(f"{stage}.{b}.conv2", c_mid, c_mid, y // stride, y // stride, 3, 3, stride=stride))
        layers.append(conv(f"{stage}.{b}.conv3", c_out, c_mid, y // stride, y // stride, 1, 1))
        if b == 0:
            layers.append(conv(f"{stage}.{b}.down", c_out, cin, y // stride, y // stride, 1, 1, stride=stride))
        yx = y // stride
    return yx


def resnet50() -> List[Layer]:
    """ResNet-50 [He et al. 2016]."""
    layers: List[Layer] = [conv("conv1", 64, 3, 112, 112, 7, 7, stride=2)]
    yx = 56
    yx = _resnet_bottleneck(layers, "conv2", 3, 64, 64, yx, 1)
    yx = _resnet_bottleneck(layers, "conv3", 4, 256, 128, 56, 2)
    yx = _resnet_bottleneck(layers, "conv4", 6, 512, 256, 28, 2)
    yx = _resnet_bottleneck(layers, "conv5", 3, 1024, 512, 14, 2)
    layers.append(gemm("fc", 1000, 1, 2048))
    return layers


def mobilenet_v2() -> List[Layer]:
    """MobileNetV2 [Sandler et al. 2018] inverted residual stack."""
    layers: List[Layer] = [conv("stem", 32, 3, 112, 112, 3, 3, stride=2)]
    # (t expansion, c_out, n repeats, stride), input resolution tracked.
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    c_in, res = 32, 112
    for i, (t, c_out, n, s) in enumerate(cfg):
        for b in range(n):
            stride = s if b == 0 else 1
            c_mid = c_in * t
            out_res = res // stride
            if t != 1:
                layers.append(conv(f"ir{i}.{b}.expand", c_mid, c_in, res, res, 1, 1))
            layers.append(dwconv(f"ir{i}.{b}.dw", c_mid, out_res, out_res, 3, 3, stride=stride))
            layers.append(conv(f"ir{i}.{b}.project", c_out, c_mid, out_res, out_res, 1, 1))
            c_in, res = c_out, out_res
    layers.append(conv("head", 1280, 320, 7, 7, 1, 1))
    layers.append(gemm("fc", 1000, 1, 1280))
    return layers


def mnasnet() -> List[Layer]:
    """MnasNet-A1 [Tan et al. 2019].

    Expanded so the paper's quoted layers appear with their exact dims:
      Layer1  = (32, 3, 224, 224, 3, 3)   -> stem (the paper lists output 224)
      Layer16 = (120, 40, 28, 28, 1, 1)   -> MBConv3 expand in the 40-ch stage
      Layer29 = (1, 480, 14, 14, 5, 5)    -> depthwise 5x5 in the 80->112 stage
    """
    L: List[Layer] = []
    L.append(conv("stem", 32, 3, 224, 224, 3, 3, stride=1))           # layer 1
    # SepConv k3 -> 16
    L.append(dwconv("sep.dw", 32, 112, 112, 3, 3, stride=2))          # 2
    L.append(conv("sep.pw", 16, 32, 112, 112, 1, 1))                  # 3
    # MBConv6 k3 x2 -> 24, stride 2
    L.append(conv("mb1.0.expand", 96, 16, 112, 112, 1, 1))            # 4
    L.append(dwconv("mb1.0.dw", 96, 56, 56, 3, 3, stride=2))          # 5
    L.append(conv("mb1.0.project", 24, 96, 56, 56, 1, 1))             # 6
    L.append(conv("mb1.1.expand", 144, 24, 56, 56, 1, 1))             # 7
    L.append(dwconv("mb1.1.dw", 144, 56, 56, 3, 3))                   # 8
    L.append(conv("mb1.1.project", 24, 144, 56, 56, 1, 1))            # 9
    # MBConv3 k5 x3 -> 40, stride 2
    L.append(conv("mb2.0.expand", 72, 24, 56, 56, 1, 1))              # 10
    L.append(dwconv("mb2.0.dw", 72, 28, 28, 5, 5, stride=2))          # 11
    L.append(conv("mb2.0.project", 40, 72, 28, 28, 1, 1))             # 12
    L.append(conv("mb2.1.expand", 120, 40, 28, 28, 1, 1))             # 13
    L.append(dwconv("mb2.1.dw", 120, 28, 28, 5, 5))                   # 14
    L.append(conv("mb2.1.project", 40, 120, 28, 28, 1, 1))            # 15
    L.append(conv("mb2.2.expand", 120, 40, 28, 28, 1, 1))             # 16  <- paper Layer16
    L.append(dwconv("mb2.2.dw", 120, 28, 28, 5, 5))                   # 17
    L.append(conv("mb2.2.project", 40, 120, 28, 28, 1, 1))            # 18
    # MBConv6 k3 x4 -> 80, stride 2
    L.append(conv("mb3.0.expand", 240, 40, 28, 28, 1, 1))             # 19
    L.append(dwconv("mb3.0.dw", 240, 14, 14, 3, 3, stride=2))         # 20
    L.append(conv("mb3.0.project", 80, 240, 14, 14, 1, 1))            # 21
    for b in (1, 2, 3):                                               # 22..30
        L.append(conv(f"mb3.{b}.expand", 480, 80, 14, 14, 1, 1))
        L.append(dwconv(f"mb3.{b}.dw", 480, 14, 14, 5 if b == 3 else 3,
                        5 if b == 3 else 3))
        L.append(conv(f"mb3.{b}.project", 80, 480, 14, 14, 1, 1))
    # layer 29 == mb3.3.dw = dwconv(480, 14, 14, 5, 5)                <- paper Layer29
    # MBConv6 k3 x2 -> 112
    for b in (0, 1):
        cin = 80 if b == 0 else 112
        L.append(conv(f"mb4.{b}.expand", cin * 6, cin, 14, 14, 1, 1))
        L.append(dwconv(f"mb4.{b}.dw", cin * 6, 14, 14, 3, 3))
        L.append(conv(f"mb4.{b}.project", 112, cin * 6, 14, 14, 1, 1))
    # MBConv6 k5 x3 -> 160, stride 2
    for b in (0, 1, 2):
        cin = 112 if b == 0 else 160
        stride = 2 if b == 0 else 1
        L.append(conv(f"mb5.{b}.expand", cin * 6, cin, 14, 14, 1, 1))
        L.append(dwconv(f"mb5.{b}.dw", cin * 6, 7, 7, 5, 5, stride=stride))
        L.append(conv(f"mb5.{b}.project", 160, cin * 6, 7, 7, 1, 1))
    # MBConv6 k3 x1 -> 320
    L.append(conv("mb6.0.expand", 960, 160, 7, 7, 1, 1))
    L.append(dwconv("mb6.0.dw", 960, 7, 7, 3, 3))
    L.append(conv("mb6.0.project", 320, 960, 7, 7, 1, 1))
    L.append(conv("head", 1280, 320, 7, 7, 1, 1))
    L.append(gemm("fc", 1000, 1, 1280))
    return L


def bert_base(seq: int = 512) -> List[Layer]:
    """BERT-base encoder GEMMs [Devlin et al. 2018], one representative block
    (the paper maps GEMM (M,N,K) -> (K_conv, C, Y))."""
    d, dff, h = 768, 3072, 12
    return [
        gemm("qkv_proj", 3 * d, seq, d),
        gemm("attn_scores", seq, seq, d // h),
        gemm("attn_ctx", seq, d // h, seq),
        gemm("out_proj", d, seq, d),
        gemm("ffn_up", dff, seq, d),
        gemm("ffn_down", d, seq, dff),
    ]


def dlrm() -> List[Layer]:
    """DLRM [Naumov et al. 2019] MLP towers (matrix-vector per request)."""
    bot = [13, 512, 256, 64]
    top = [512, 512, 256, 1]
    layers = []
    for i in range(len(bot) - 1):
        layers.append(gemm(f"bot{i}", bot[i + 1], 1, bot[i]))
    for i in range(len(top) - 1):
        layers.append(gemm(f"top{i}", top[i + 1], 1, top[i]))
    return layers


def ncf() -> List[Layer]:
    """NCF [He et al. 2017] MLP tower (matrix-vector)."""
    widths = [256, 256, 128, 64, 1]
    return [gemm(f"mlp{i}", widths[i + 1], 1, widths[i])
            for i in range(len(widths) - 1)]


MODEL_ZOO = {
    "alexnet": alexnet,
    "resnet50": resnet50,
    "mobilenetv2": mobilenet_v2,
    "mnasnet": mnasnet,
    "bert": bert_base,
    "dlrm": dlrm,
    "ncf": ncf,
}


def get_model(name: str) -> List[Layer]:
    return MODEL_ZOO[name]()


def layers_as_array(layers: Sequence[Layer]) -> np.ndarray:
    """(L, 6) int64 dim matrix for vectorized cost evaluation."""
    return np.stack([l.as_array() for l in layers])
