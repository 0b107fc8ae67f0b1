"""The out-of-core tier of the port.  So far only the hot-row selection of
``hot`` (the serving fleet's eager/lazy delta split); the windowed trainers,
the host store and the staging engine come with the out-of-core slice."""
