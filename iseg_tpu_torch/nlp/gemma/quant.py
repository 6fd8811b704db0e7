"""Back-compat alias: the weight-only int8 quantizer is generic tree
machinery and lives in :mod:`iseg_tpu_torch.ops.quant` (counterpart of
``iseg_tpu/nlp/gemma/quant.py``)."""

from iseg_tpu_torch.ops.quant import (  # noqa: F401
    QTensor,
    dequantize_tree,
    is_quantized,
    quantize_tree,
)
