// gprof driver for the host bc stage on a DUMPED corpus (e.g. the
// rendered terminal session — tiny per-frame deltas, the workload whose
// per-frame fixed costs the bc path pays).
//
//   python scripts/dump_corpus.py terminal /tmp/term.blob
//   g++ -O3 -march=native -std=c++17 -pg -pthread \
//       -o /tmp/prof_bc scripts/prof_bc_main.cpp \
//       -DSPDEC_SRC='"jsplayer_tpu/native/spdec.cpp"'
//   /tmp/prof_bc /tmp/term.blob 20 && gprof /tmp/prof_bc gmon.out | head -40
//
// Blob layout: i64 T | i64 X | i64 Y | i64 lengths[T] | frame bytes...

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include SPDEC_SRC

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: prof_bc blob [reps]\n"); return 2; }
  int reps = argc > 2 ? atoi(argv[2]) : 10;
  FILE* fp = fopen(argv[1], "rb");
  if (!fp) { perror("open"); return 2; }
  int64_t hdr[3];
  if (fread(hdr, 8, 3, fp) != 3) return 2;
  const int T = (int)hdr[0], X = (int)hdr[1], Y = (int)hdr[2];
  std::vector<int64_t> lens64(T);
  if (fread(lens64.data(), 8, T, fp) != (size_t)T) return 2;
  std::vector<long> offs(T), lens(T);
  long total = 0;
  for (int t = 0; t < T; t++) { offs[t] = total; lens[t] = (long)lens64[t]; total += lens[t]; }
  std::vector<uint8_t> blob(total);
  if (fread(blob.data(), 1, total, fp) != (size_t)total) return 2;
  fclose(fp);

  const size_t npix = (size_t)X * Y;
  const size_t nb = (size_t)((X + 15) / 16) * ((Y + 15) / 16);
  const int K = 2;
  std::vector<uint32_t> plane(npix * T);
  std::vector<int32_t> mvk((size_t)T * K * 2);
  std::vector<uint8_t> bcode((size_t)T * nb), rloc((size_t)T * nb * 4);
  std::vector<uint8_t> changed(T), signif(T);

  double best = 1e30;
  for (int r = 0; r < reps; r++) {
    auto t0 = std::chrono::steady_clock::now();
    sp_decode_streams_bc(1, T, X, Y, 24, blob.data(), offs.data(),
                         lens.data(), 0, K, plane.data(), mvk.data(),
                         bcode.data(), rloc.data(), changed.data(),
                         signif.data(), 1);
    double dt = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    if (dt < best) best = dt;
  }
  printf("bc stage: %d frames, best %.1f fps/core\n", T, T / best);
  return 0;
}
