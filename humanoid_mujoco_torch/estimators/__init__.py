from .sensors import SensorModel, default_sensor_model, measure
from .kalman import EKFConfig, EKFState, ekf_init, ekf_update
from .unscented import UKFConfig, UKFState, ukf_init, ukf_update
from .ground_truth import (GroundTruthState, ground_truth_init,
                           ground_truth_update)
from .batch import BatchConfig, BatchState, batch_init, batch_update

__all__ = [
    "SensorModel", "default_sensor_model", "measure",
    "EKFConfig", "EKFState", "ekf_init", "ekf_update",
    "UKFConfig", "UKFState", "ukf_init", "ukf_update",
    "GroundTruthState", "ground_truth_init", "ground_truth_update",
    "BatchConfig", "BatchState", "batch_init", "batch_update",
]
