from point_cloud_classifier_tpu_torch.models.deep_sets import DeepSets
from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper

__all__ = ["DeepSets", "ModelWrapper"]
