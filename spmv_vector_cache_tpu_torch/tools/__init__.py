from . import benchapp, matrixtools, realistic, scaling, suite, vecdiff  # noqa: F401
