"""repro_torch.quant — quantized point storage and asymmetric-distance
search, the counterpart of ``repro.quant``.

Points are stored as uint8 codes (SQ8: 1 byte/dim; PQ: 1 byte/sub-
codebook) and queries rerank the LSH-selected candidates with ADC
distances on the codes (``repro_torch.kernels.adc``), reading float rows
only for the final R, or never with ``store_raw=False``.  Reached
through the facade:

    build_index(data, IndexConfig(backend="flat-pq"))
    build_index(data, IndexConfig(backend="flat", options={"quant": "sq8"}))
"""
from .codec import PQCodec, SQ8Codec, train_codec, train_pq, train_sq8  # noqa: F401
from .search import quant_ann_query, quant_cp_search  # noqa: F401
