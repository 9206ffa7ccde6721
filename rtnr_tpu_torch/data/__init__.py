"""Host-side file formats of the port: PLY (``ply``), the reference's
``.oct`` scene cache (``oct``), E57 scans (``e57``, ``e57_write``), JPEG
(``jpeg``) and the ctypes bindings of the host library (``native``)."""
