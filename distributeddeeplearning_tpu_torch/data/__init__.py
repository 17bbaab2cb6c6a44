"""Input pipelines of the port, none of which needs TensorFlow:

- ``synthetic``: the synthetic image and text sets;
- ``tfrecords``: the sharded TFRecord pipeline, the reference's tf.data
  recipe on the port's record reader and ``preprocessing``;
- ``images``: class-directory JPEG trees on the same recipe;
- ``native_pipeline``: the C record reader and C JPEG decoder (PIL where it
  declines), bit for bit the reference's;
- ``raw_cache``: the decode-once uint8 cache and its on-device
  ``uint8_normalizer``;
- ``preprocessing``: decode (PIL), resize (torch), crops, mean subtraction;
- ``proto``: the TF-free Example encoder and ``RecordWriter``;
- ``_native``, ``_native_image``, ``_native_build``: the ctypes bindings
  of ``csrc/ddlt_records.c`` and ``csrc/ddlt_image.c``, built with the
  host compiler into ``_build/``;
- ``convert_tfrecords``, ``prepare_imagenet``, ``val_maps``,
  ``class_index`` (with ``files/``): ImageNet preparation;
- ``bench_data``: seeded synthetic JPEG shards at ILSVRC resolutions.
"""
