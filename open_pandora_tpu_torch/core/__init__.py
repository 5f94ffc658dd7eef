from open_pandora_tpu_torch.core.config import (
    PandoraConfig,
    UNet3DConfig,
    VAEConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    LLaMAConfig,
    QFormerConfig,
    DiffusionConfig,
    SamplerConfig,
    TrainConfig,
    MeshConfig,
    load_config,
)
from open_pandora_tpu_torch.core.dtypes import (DTypePolicy, default_policy,
                                                golden_fp32_policy)
