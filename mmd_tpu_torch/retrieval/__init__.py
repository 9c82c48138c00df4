from mmd_tpu_torch.retrieval.image import ImageCorpus
from mmd_tpu_torch.retrieval.text import TextCorpus, SemanticSearch
