"""The out-of-core tier of the port (``cfk_tpu/offload`` in one process).

- ``budget`` — the memory predicate (``fits_device`` at the device's own
  memory) and the window, pool, hot-row and Gram reservations;
- ``store`` — ``HostFactorStore``, the host-RAM factor tables (pinned,
  crc32-sealed shards) and the int8 host quantizer;
- ``window`` — the stream, ring and bucket window plans;
- ``hot`` — the hot-row selection and the hot/delta window maps;
- ``staging`` — ``WindowStager`` and the host-to-device window copies;
- ``windowed`` — ``train_als_host_window`` and ``train_ials_host_window``.

The multi-process fleet (``exchange``, ``elastic``) is not ported yet.
"""
