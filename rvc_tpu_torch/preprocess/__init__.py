"""Dataset preprocessing: silence slicing, feature extraction, dataset build
(counterpart of `rvc_tpu/preprocess`)."""

from rvc_tpu_torch.preprocess.dataset import DatasetBuilder
from rvc_tpu_torch.preprocess.features import FeatureExtractor
from rvc_tpu_torch.preprocess.preprocessor import AudioPreprocessor
from rvc_tpu_torch.preprocess.slicer import Slicer

__all__ = ["Slicer", "AudioPreprocessor", "FeatureExtractor", "DatasetBuilder"]
