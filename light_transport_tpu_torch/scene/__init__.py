from light_transport_tpu_torch.scene.material import (  # noqa: F401
    BSDF_DIFFUSE,
    BSDF_MIRROR,
    BSDF_NONE,
    BSDF_TRANSMISSIVE,
    Color,
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.geometry import TriangleMesh  # noqa: F401
from light_transport_tpu_torch.scene.lights import LightTable  # noqa: F401
from light_transport_tpu_torch.scene.scene import Scene  # noqa: F401
from light_transport_tpu_torch.scene.cornell import (  # noqa: F401
    cornell_box_scene,
)
from light_transport_tpu_torch.scene.medium import LayeredMedium  # noqa: F401
