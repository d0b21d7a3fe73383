#!/bin/bash
# ASan/UBSan build + test of the native host layer (SURVEY §5 sanitizer
# row).  Builds colate_tpu/native/*.cpp with address+undefined sanitizers
# into /tmp/libcolate_io_asan.so and runs the native-exercising test
# files against it (COLATE_NATIVE_SO override + libasan preloaded into
# the non-instrumented python host).
#
# Usage: bash tools/native_sanitize.sh [pytest args...]
#        bash tools/native_sanitize.sh --tsan   # ThreadSanitizer pass
#          over the threaded reader->worker pipeline via the standalone
#          C++ driver (tools/tsan_stream.cpp; needs the bench fixture,
#          generated by bench.py under /tmp/colate_bench)
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
SRC="$REPO/colate_tpu/native"
OUT=/tmp/libcolate_io_asan.so

if [ "$1" = "--tsan" ]; then
  g++ -O1 -g -std=c++17 -fsanitize=thread \
      "$SRC"/io.cpp "$SRC"/em.cpp "$SRC"/hts.cpp "$SRC"/cond.cpp \
      "$REPO"/tools/tsan_stream.cpp -o /tmp/tsan_stream -lz -lpthread
  TSAN_OPTIONS=halt_on_error=1 /tmp/tsan_stream /tmp/colate_bench 4
  echo "native tsan: OK"
  exit 0
fi

g++ -O1 -g -std=c++17 -shared -fPIC \
    -fsanitize=address,undefined -fno-sanitize-recover=undefined \
    "$SRC"/io.cpp "$SRC"/em.cpp "$SRC"/hts.cpp "$SRC"/cond.cpp \
    "$SRC"/la.cpp -o "$OUT" -lz -lpthread

ASAN_RT="$(g++ -print-file-name=libasan.so)"
UBSAN_RT="$(g++ -print-file-name=libubsan.so)"

# leak check off: the python interpreter itself "leaks" at exit and the
# native handles are process-lifetime caches by design
env LD_PRELOAD="$ASAN_RT:$UBSAN_RT" \
  ASAN_OPTIONS=detect_leaks=0,abort_on_error=1 \
  UBSAN_OPTIONS=print_stacktrace=1,halt_on_error=1 \
  COLATE_NATIVE_SO="$OUT" COLATE_NATIVE_REQUIRED=1 \
  python -m pytest "$REPO/tests/test_native_io.py" \
    "$REPO/tests/test_aux_modes.py" "$REPO/tests/test_mut_golden.py" \
    "$REPO/tests/test_local_ancestry.py" "$REPO/tests/test_cram.py" \
    "$REPO/tests/test_tree_mode.py" "$REPO/tests/test_bam_modes.py" \
    -q -p no:cacheprovider "$@"
echo "native sanitize: OK"
