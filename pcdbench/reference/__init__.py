"""The plain reference that decides ``correct``: meshes, bases and
quadrature of the configurations (:mod:`.mesh`, :mod:`.quadrature`,
:mod:`.step`), the steady Navier-Stokes residual (:mod:`.navier_stokes`)
and its readings of a program's state (:mod:`.judge`).  Plain NumPy and
PyTorch; nothing here imports the program under test."""
