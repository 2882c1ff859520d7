"""Host-side rigid-body physics (copy of granite_tpu/physics/; reference:
physics/physics_system.hpp)."""

from .physics_system import (CollisionEvent, CollisionMesh,
                             CollisionMeshComponent, ConvexMeshPart,
                             ForceComponent, InteractionType,
                             KinematicCharacter, MaterialInfo, MeshType,
                             PhysicsComponent, PhysicsHandle,
                             PhysicsSystem, RaycastResult,
                             INTERACTION_TYPE_ALL_BITS,
                             INTERACTION_TYPE_DYNAMIC_BIT,
                             INTERACTION_TYPE_INVISIBLE_BIT,
                             INTERACTION_TYPE_KINEMATIC_BIT,
                             INTERACTION_TYPE_STATIC_BIT, PHYSICS_TICK)
from .shapes import (Box, Capsule, Cone, ConvexHull, Cylinder, Posed,
                     Shape, Sphere, gjk_distance, epa_penetration)

__all__ = [
    "PhysicsSystem", "PhysicsHandle", "MaterialInfo", "ConvexMeshPart",
    "CollisionMesh", "CollisionMeshComponent", "CollisionEvent",
    "PhysicsComponent", "ForceComponent", "InteractionType", "MeshType",
    "KinematicCharacter", "RaycastResult", "PHYSICS_TICK",
    "INTERACTION_TYPE_ALL_BITS", "INTERACTION_TYPE_STATIC_BIT",
    "INTERACTION_TYPE_DYNAMIC_BIT", "INTERACTION_TYPE_INVISIBLE_BIT",
    "INTERACTION_TYPE_KINEMATIC_BIT",
    "Shape", "Sphere", "Box", "Capsule", "Cylinder", "Cone",
    "ConvexHull", "Posed", "gjk_distance", "epa_penetration",
]
