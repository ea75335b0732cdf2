from point_cloud_classifier_tpu_torch.models.deep_sets import DeepSets
from point_cloud_classifier_tpu_torch.models.fully_connected_net import FullyConnectedNet
from point_cloud_classifier_tpu_torch.models.graph_net import GraphNet
from point_cloud_classifier_tpu_torch.models.logistic_regression import LogRegression
from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper

__all__ = ["DeepSets", "FullyConnectedNet", "GraphNet", "LogRegression", "ModelWrapper"]
