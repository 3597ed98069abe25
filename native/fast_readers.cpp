// Native data loader for tpu-md-bench (reference counterpart:
// src/verletlist/atom.c readAtom_* — the reference's reader layer is
// native C; this is this build's native equivalent, bound to Python
// via ctypes from mdbench_tpu/io/native.py).
//
// Parses LAMMPS dump (.dmp) and the native restart (.in) formats into
// caller-provided flat arrays. ~20x faster than the pure-Python parser
// on the 100k+ atom inputs used by the benchmark configs.
//
// Build: g++ -O3 -shared -fPIC -o libfastread.so fast_readers.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Read the whole file into a heap buffer. Returns nullptr on failure.
char* slurp(const char* path, long* out_len) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return nullptr;
    std::fseek(fp, 0, SEEK_END);
    long len = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(len + 1));
    if (!buf) {
        std::fclose(fp);
        return nullptr;
    }
    size_t rd = std::fread(buf, 1, len, fp);
    std::fclose(fp);
    buf[rd] = '\0';
    *out_len = static_cast<long>(rd);
    return buf;
}

inline char* next_line(char* p) {
    while (*p && *p != '\n') p++;
    return *p ? p + 1 : p;
}

}  // namespace

extern "C" {

// Parse a LAMMPS dump with "ITEM: ATOMS id type x y z vx vy vz".
// Fills x/v (natoms*3, atom-id order) and types (natoms, 0-based).
// box receives (xprd, yprd, zprd). Returns natoms, or -1 on error.
long parse_dmp(const char* path, double* x, double* v, int* types,
               double* box, long capacity) {
    long len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;

    long natoms = 0;
    char* p = buf;
    while (*p) {
        if (std::strncmp(p, "ITEM: ", 6) == 0) {
            char* item = p + 6;
            if (std::strncmp(item, "TIMESTEP", 8) == 0) {
                p = next_line(next_line(p));
            } else if (std::strncmp(item, "NUMBER OF ATOMS", 15) == 0) {
                p = next_line(p);
                natoms = std::strtol(p, &p, 10);
                if (natoms > capacity) {
                    std::free(buf);
                    return -2;  // caller buffer too small
                }
                p = next_line(p);
            } else if (std::strncmp(item, "BOX BOUNDS pp pp pp", 19) == 0) {
                p = next_line(p);
                for (int d = 0; d < 3; d++) {
                    double lo = std::strtod(p, &p);
                    double hi = std::strtod(p, &p);
                    box[d] = hi - lo;
                    p = next_line(p);
                }
            } else if (std::strncmp(item, "ATOMS id type x y z vx vy vz",
                                    28) == 0) {
                p = next_line(p);
                for (long i = 0; i < natoms; i++) {
                    long id = std::strtol(p, &p, 10) - 1;
                    if (id < 0 || id >= natoms) {
                        std::free(buf);
                        return -3;
                    }
                    types[id] = static_cast<int>(
                        std::strtol(p, &p, 10) - 1);  // 0-based
                    for (int d = 0; d < 3; d++)
                        x[id * 3 + d] = std::strtod(p, &p);
                    for (int d = 0; d < 3; d++)
                        v[id * 3 + d] = std::strtod(p, &p);
                    p = next_line(p);
                }
                break;  // first frame only (reference reads ts < 1)
            } else {
                p = next_line(p);
            }
        } else {
            p = next_line(p);
        }
    }
    std::free(buf);
    return natoms;
}

// Parse the native .in restart written by writeAtom (CSV
// "type,mass,x,y,z,vx,vy,vz,0") or the space-separated variant.
// Header: "natoms xlo xhi ylo yhi zlo zhi". Returns natoms or -1.
long parse_in(const char* path, double* x, double* v, int* types,
              double* box, long capacity) {
    long len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;
    // commas behave like spaces for strtod/strtol? No — normalize.
    for (long i = 0; i < len; i++)
        if (buf[i] == ',') buf[i] = ' ';

    char* p = buf;
    long natoms = std::strtol(p, &p, 10);
    if (natoms > capacity) {
        std::free(buf);
        return -2;
    }
    double lo, hi;
    for (int d = 0; d < 3; d++) {
        lo = std::strtod(p, &p);
        hi = std::strtod(p, &p);
        box[d] = hi - lo;
    }
    p = next_line(p);
    for (long i = 0; i < natoms; i++) {
        // count tokens on this line to disambiguate the two formats
        char* q = p;
        int ntok = 0;
        while (*q && *q != '\n') {
            while (*q == ' ' || *q == '\t' || *q == '\r') q++;
            if (*q && *q != '\n') {
                ntok++;
                while (*q && *q != ' ' && *q != '\t' && *q != '\n' &&
                       *q != '\r')
                    q++;
            }
        }
        if (ntok >= 9) {  // type mass x y z vx vy vz flag
            types[i] = static_cast<int>(std::strtod(p, &p));
            std::strtod(p, &p);  // mass
        } else {  // mass x y z vx vy vz
            types[i] = 0;
            std::strtod(p, &p);  // mass
        }
        for (int d = 0; d < 3; d++) x[i * 3 + d] = std::strtod(p, &p);
        for (int d = 0; d < 3; d++) v[i * 3 + d] = std::strtod(p, &p);
        p = next_line(p);
    }
    std::free(buf);
    return natoms;
}

}  // extern "C"
