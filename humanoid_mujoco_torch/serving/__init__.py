from .filtering import FilterService, ServingFilter
from .server import MPCServer, serve
from .state_estimation import (find_ideal_root_height, root_height_scores,
                               set_robot_state)

__all__ = ["find_ideal_root_height", "root_height_scores",
           "set_robot_state", "MPCServer", "serve", "ServingFilter",
           "FilterService"]
