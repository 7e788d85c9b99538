"""The kernels' build key: a library is rebuilt when its source, or a
header the source includes from its own directory, changes (CPU only)."""
from repro_torch import kernels as K


def write(path, text):
    path.write_text(text)
    return path


def test_library_key_follows_the_headers_a_source_includes(tmp_path):
    """Copies of a source and its headers: an edit to a header the source
    includes (directly or through another header) changes the library
    path; an edit to a file it does not include, or a header of the same
    name elsewhere, does not."""
    src = write(tmp_path / "k.cu",
                '#include <cuda_runtime.h>\n#include "a.cuh"\n'
                'int f() { return g(); }\n')
    a = write(tmp_path / "a.cuh", '#pragma once\n  #  include "b.cuh"\n'
              "inline int g() { return h(); }\n")
    b = write(tmp_path / "b.cuh", "#pragma once\ninline int h() { return 1; }\n")
    other = write(tmp_path / "c.cuh", "inline int c() { return 3; }\n")
    (tmp_path / "sub").mkdir()
    write(tmp_path / "sub" / "a.cuh", "unrelated\n")
    assert K.local_headers(src) == [a, b]
    first = K.library_path(src)
    assert first == K.library_path(src)
    assert first.parent == K.BUILD_DIR and first.name.startswith("k-")
    write(other, "inline int c() { return 4; }\n")
    write(tmp_path / "sub" / "a.cuh", "changed\n")
    assert K.library_path(src) == first
    write(b, "#pragma once\ninline int h() { return 2; }\n")
    second = K.library_path(src)
    assert second != first
    write(a, a.read_text() + "// an edit\n")
    assert K.library_path(src) not in (first, second)
