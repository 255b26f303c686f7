"""The paper's own model family: a CNN with convolutional + fully-connected
layers at CIFAR size (32x32x3 input, convs 32/64/128, fc 256/10)."""
from repro_torch.models.cnn import CNNConfig


def config() -> CNNConfig:
    return CNNConfig()


def smoke_config() -> CNNConfig:
    return CNNConfig(name="paper-cnn-smoke", img=16,
                     convs=(CNNConfig().convs[0],), fcs=(32, 10))
