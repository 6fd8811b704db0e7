"""Shared string-constant vocabulary (copy of ``iseg_tpu/static_strings.py``):
norm kinds, dataset names with their class counts and ignore labels, and
the batch I/O keys."""

# normalization kinds (see iseg_tpu_torch.nn.norm.normalization)
BATCH_NORM = "batch_norm"
SYNC_BATCH_NORM = "sync_batch_norm"
GROUP_NORM = "group_norm"
LAYER_NORM = "layer_norm"
RMS_NORM = "rms_norm"

# dataset names
PASCAL_VOC2012 = "pascal_voc2012"
CITYSCAPES = "cityscapes"
ADE20K = "ade20k"
COCO_STUFF = "cocostuff"
PASCAL_CONTEXT = "pascal_context"
CAMVID = "camvid"

DATASET_NUM_CLASSES = {
    PASCAL_VOC2012: 21,
    CITYSCAPES: 19,
    ADE20K: 150,
    COCO_STUFF: 171,
    PASCAL_CONTEXT: 59,
    CAMVID: 11,
}

DATASET_IGNORE_LABEL = {
    PASCAL_VOC2012: 255,
    CITYSCAPES: 255,
    ADE20K: 0,
    COCO_STUFF: 255,
    PASCAL_CONTEXT: 255,
    CAMVID: 255,
}

# batch I/O keys
IMAGE = "image"
LABEL = "label"

# backbone names live in iseg_tpu_torch.backbones.registry (list_backbones()).
