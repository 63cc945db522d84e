from . import colmap  # noqa: F401
from .colmap import colmap_init  # noqa: F401
from .camera import Camera, build_camera  # noqa: F401
from .dataset import CameraDataset, TrainableCameraDataset, prepare_dataset  # noqa: F401
