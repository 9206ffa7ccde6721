"""Host-side file formats of the port: PLY (``ply``) and the reference's
``.oct`` scene cache (``oct``), numpy only."""
