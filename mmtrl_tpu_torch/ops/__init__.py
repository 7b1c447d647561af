from mmtrl_tpu_torch.ops.gae import compute_gae
from mmtrl_tpu_torch.ops.mfcc import MFCCParams, log_mel_spectrogram, mfcc, mfcc_image

__all__ = ["MFCCParams", "mfcc", "mfcc_image", "log_mel_spectrogram", "compute_gae"]
