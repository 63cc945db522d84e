// Native PLY and COLMAP I/O for reduced_3dgs_torch: binary PLY read and
// write, and the COLMAP points3D.bin parser, through a C ABI that
// reduced_3dgs_torch/models/native_io.py binds with ctypes. It is built with
// g++ (-O3 -shared -fPIC -std=c++17) at first use into the package's build
// directory. The numpy code in models/ply.py and dataset/colmap.py is the
// behavioural definition; the files written here are byte-identical to its.
// (The port's copy of native/io.cpp; both parsers check the file's length
// before they allocate or seek.)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

struct Property {
    std::string name;
    int dtype;   // 0:i1 1:u1 2:i2 3:u2 4:i4 5:u4 6:f4 7:f8
};

int dtype_size(int d) {
    switch (d) {
        case 0: case 1: return 1;
        case 2: case 3: return 2;
        case 4: case 5: case 6: return 4;
        default: return 8;
    }
}

int parse_dtype(const std::string& s) {
    if (s == "char" || s == "int8") return 0;
    if (s == "uchar" || s == "uint8") return 1;
    if (s == "short" || s == "int16") return 2;
    if (s == "ushort" || s == "uint16") return 3;
    if (s == "int" || s == "int32") return 4;
    if (s == "uint" || s == "uint32") return 5;
    if (s == "float" || s == "float32") return 6;
    if (s == "double" || s == "float64") return 7;
    return -1;
}

struct Element {
    std::string name;
    uint64_t count = 0;
    std::vector<Property> props;
    uint64_t row_size() const {
        uint64_t s = 0;
        for (auto& p : props) s += dtype_size(p.dtype);
        return s;
    }
};

struct PlyFile {
    std::vector<Element> elements;
    std::vector<std::vector<char>> element_data;  // column-contiguous rows
    std::string error;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- PLY read
// Parses a binary_little_endian PLY. Returns an opaque handle (or null).
void* r3dgs_ply_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* ply = new PlyFile();

    char line[4096];
    bool in_header = true;
    bool binary_le = false;
    while (in_header && fgets(line, sizeof(line), f)) {
        std::string s(line);
        while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
        if (s.rfind("format ", 0) == 0) {
            binary_le = s.find("binary_little_endian") != std::string::npos;
        } else if (s.rfind("element ", 0) == 0) {
            Element e;
            char name[256];
            unsigned long long cnt;
            if (sscanf(s.c_str(), "element %255s %llu", name, &cnt) == 2) {
                e.name = name;
                e.count = cnt;
                ply->elements.push_back(e);
            }
        } else if (s.rfind("property ", 0) == 0 && !ply->elements.empty()) {
            char type[64], name[256];
            if (sscanf(s.c_str(), "property %63s %255s", type, name) == 2) {
                int dt = parse_dtype(type);
                if (dt < 0) { ply->error = "unsupported property type"; }
                ply->elements.back().props.push_back({name, dt});
            }
        } else if (s == "end_header") {
            in_header = false;
        }
    }
    if (in_header || !binary_le || !ply->error.empty()) {
        fclose(f);
        delete ply;
        return nullptr;
    }
    // The body must hold every element: a count larger than the file is an
    // error, not an allocation.
    long body = ftell(f);
    if (body < 0 || fseek(f, 0, SEEK_END) != 0) { fclose(f); delete ply; return nullptr; }
    uint64_t left = (uint64_t)(ftell(f) - body);
    fseek(f, body, SEEK_SET);
    for (auto& e : ply->elements) {
        uint64_t row = e.row_size();
        if (row && e.count > left / row) { fclose(f); delete ply; return nullptr; }
        left -= e.count * row;
    }
    for (auto& e : ply->elements) {
        uint64_t bytes = e.count * e.row_size();
        std::vector<char> buf(bytes);
        if (bytes && fread(buf.data(), 1, bytes, f) != bytes) {
            fclose(f);
            delete ply;
            return nullptr;
        }
        ply->element_data.push_back(std::move(buf));
    }
    fclose(f);
    return ply;
}

int r3dgs_ply_num_elements(void* h) {
    return (int)((PlyFile*)h)->elements.size();
}

const char* r3dgs_ply_element_name(void* h, int i) {
    return ((PlyFile*)h)->elements[i].name.c_str();
}

uint64_t r3dgs_ply_element_count(void* h, int i) {
    return ((PlyFile*)h)->elements[i].count;
}

int r3dgs_ply_num_properties(void* h, int i) {
    return (int)((PlyFile*)h)->elements[i].props.size();
}

const char* r3dgs_ply_property_name(void* h, int i, int j) {
    return ((PlyFile*)h)->elements[i].props[j].name.c_str();
}

int r3dgs_ply_property_dtype(void* h, int i, int j) {
    return ((PlyFile*)h)->elements[i].props[j].dtype;
}

// Copies the raw interleaved rows of element i into out (caller sized).
void r3dgs_ply_element_rows(void* h, int i, char* out) {
    auto* ply = (PlyFile*)h;
    memcpy(out, ply->element_data[i].data(), ply->element_data[i].size());
}

void r3dgs_ply_close(void* h) { delete (PlyFile*)h; }

// --------------------------------------------------------------- PLY write
// Writes a binary_little_endian PLY in one shot. `header` is the full ascii
// header (including end_header\n); bufs/sizes are the per-element
// interleaved row blobs.
int r3dgs_ply_write(const char* path, const char* header,
                    const char** bufs, const uint64_t* sizes, int n) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t len = strlen(header);
    bool ok = fwrite(header, 1, len, f) == len;
    for (int i = 0; ok && i < n; i++) ok = fwrite(bufs[i], 1, sizes[i], f) == sizes[i];
    return (fclose(f) == 0 && ok) ? 0 : -1;
}

// ----------------------------------------------------------- COLMAP points
// Parses points3D.bin into xyz (f64[n,3]) and rgb (u8[n,3]). Two-call
// protocol: first with xyz==null to get the count.
// A file that ends early, or whose count cannot fit in it (43 bytes and a
// track length per point at least), gives -1.
int64_t r3dgs_colmap_points(const char* path, double* xyz, uint8_t* rgb) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
    long size = ftell(f);
    rewind(f);
    uint64_t n;
    if (size < 8 || fread(&n, 8, 1, f) != 1) { fclose(f); return -1; }
    if (n > (uint64_t)(size - 8) / 51) { fclose(f); return -1; }
    if (!xyz) { fclose(f); return (int64_t)n; }
    for (uint64_t i = 0; i < n; i++) {
        struct __attribute__((packed)) {
            uint64_t id;
            double x, y, z;
            uint8_t r, g, b;
            double err;
        } rec;
        if (fread(&rec, sizeof(rec), 1, f) != 1) { fclose(f); return -1; }
        xyz[i * 3 + 0] = rec.x;
        xyz[i * 3 + 1] = rec.y;
        xyz[i * 3 + 2] = rec.z;
        rgb[i * 3 + 0] = rec.r;
        rgb[i * 3 + 1] = rec.g;
        rgb[i * 3 + 2] = rec.b;
        uint64_t track_len;
        if (fread(&track_len, 8, 1, f) != 1) { fclose(f); return -1; }
        if (track_len > (uint64_t)size / 8 ||
            fseek(f, (long)(8 * track_len), SEEK_CUR) != 0 || ftell(f) > size) {
            fclose(f);
            return -1;
        }
    }
    fclose(f);
    return (int64_t)n;
}

}  // extern "C"
