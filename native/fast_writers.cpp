// Native output writers for tpu-md-bench (reference counterparts:
// src/verletlist/vtk.c and tracing.{c,h} — both native C in the
// reference; these are this build's native equivalents, bound to
// Python via ctypes from mdbench_tpu/io/native.py).
//
// The VTK / tracer formats are line-per-atom text: the pure-Python
// writers cost seconds per frame at the 131k benchmark size, which is
// enough to distort --vtk runs. These produce byte-identical output.
//
// Build: g++ -O3 -shared -fPIC -o libfastwrite.so fast_writers.cpp

#include <cstdio>
#include <cstdint>

extern "C" {

// VTK UNSTRUCTURED_GRID atom dump (same layout as vtk.c:12-55 /
// io/vtk.py write_atoms_to_vtk_file). x is row-major (n, 3) float64.
// Returns 0 on success.
int write_atoms_vtk(const char* path, const double* x, long n) {
    FILE* fp = std::fopen(path, "w");
    if (!fp) return 1;
    std::fprintf(fp, "# vtk DataFile Version 2.0\n");
    std::fprintf(fp, "Particle data\n");
    std::fprintf(fp, "ASCII\n");
    std::fprintf(fp, "DATASET UNSTRUCTURED_GRID\n");
    std::fprintf(fp, "POINTS %ld double\n", n);
    for (long i = 0; i < n; i++) {
        std::fprintf(fp, "%.4f %.4f %.4f\n", x[3 * i], x[3 * i + 1],
                     x[3 * i + 2]);
    }
    std::fprintf(fp, "\n\n");
    std::fprintf(fp, "CELLS %ld %ld\n", n, 2 * n);
    for (long i = 0; i < n; i++) std::fprintf(fp, "1 %ld\n", i);
    std::fprintf(fp, "\n\n");
    std::fprintf(fp, "CELL_TYPES %ld\n", n);
    for (long i = 0; i < n; i++) std::fputs("1\n", fp);
    std::fprintf(fp, "\n\n");
    std::fprintf(fp, "POINT_DATA %ld\n", n);
    std::fprintf(fp, "SCALARS mass double\n");
    std::fprintf(fp, "LOOKUP_TABLE default\n");
    for (long i = 0; i < n; i++) std::fputs("1.0\n", fp);
    std::fprintf(fp, "\n\n");
    std::fclose(fp);
    return 0;
}

// INDEX_TRACER dump (reference tracing.h:47-123 / tracing.py
// dump_index_trace). neighbors is (n, maxneighs) int32 row-major.
int write_index_trace(const char* path, const int32_t* neighbors,
                      const int32_t* numneigh, long n, long maxneighs,
                      long vector_width) {
    FILE* fp = std::fopen(path, "w");
    if (!fp) return 1;
    for (long i = 0; i < n; i++) {
        long k = numneigh[i];
        std::fprintf(fp, "A: %ld %ld\n", i, k);
        for (long c0 = 0; c0 < k; c0 += vector_width) {
            long c1 = c0 + vector_width < k ? c0 + vector_width : k;
            int32_t mn = neighbors[i * maxneighs + c0];
            int32_t mx = mn;
            for (long c = c0; c < c1; c++) {
                int32_t j = neighbors[i * maxneighs + c];
                if (j < mn) mn = j;
                if (j > mx) mx = j;
            }
            std::fprintf(fp, "C: %d %d\n", mn, mx);
            std::fputs("I:", fp);
            for (long c = c0; c < c1; c++) {
                std::fprintf(fp, " %d", neighbors[i * maxneighs + c]);
            }
            std::fputs("\n", fp);
        }
    }
    std::fclose(fp);
    return 0;
}

// MEM_TRACER-style address-stream dump (reference tracing.h:24-45 /
// tracing.py dump_mem_trace): planar SoA byte addresses.
int write_mem_trace(const char* path, const int32_t* neighbors,
                    const int32_t* numneigh, long n, long maxneighs,
                    long nrows, long float_size) {
    FILE* fp = std::fopen(path, "w");
    if (!fp) return 1;
    const long x_base = 0;
    const long f_base = nrows * 3 * float_size;
    const long nl_base = 2 * nrows * 3 * float_size;
    for (long i = 0; i < n; i++) {
        long k = numneigh[i];
        std::fprintf(fp, "R: %ld %ld\n", x_base + i * 3 * float_size,
                     3 * float_size);
        for (long c = 0; c < k; c++) {
            std::fprintf(fp, "R: %ld 4\n",
                         nl_base + (i * maxneighs + c) * 4);
            long j = neighbors[i * maxneighs + c];
            std::fprintf(fp, "R: %ld %ld\n", x_base + j * 3 * float_size,
                         3 * float_size);
        }
        std::fprintf(fp, "W: %ld %ld\n", f_base + i * 3 * float_size,
                     3 * float_size);
    }
    std::fclose(fp);
    return 0;
}

}  // extern "C"
