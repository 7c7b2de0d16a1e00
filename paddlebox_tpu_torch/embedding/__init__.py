from paddlebox_tpu_torch.embedding.config import EmbeddingConfig  # noqa: F401
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore  # noqa: F401
from paddlebox_tpu_torch.embedding.working_set import PassWorkingSet  # noqa: F401
