"""Runtime checks for the port's hot paths, and the runtime's
placement-group and scheduling-strategy API (``ray_tpu.util``'s)."""

from .placement_group import (placement_group, remove_placement_group,
                              placement_group_table, PlacementGroup)
from .scheduling_strategies import (PlacementGroupSchedulingStrategy,
                                    NodeAffinitySchedulingStrategy,
                                    NodeLabelSchedulingStrategy)
